"""The port's host evaluator (``eval/evaluator.py:evaluate_checkpoint``)
against the JAX package's on the CPU, with the same weights (flax
parameters through ``from_jax``), deterministic actions, hidden 32 and
RIR length 400: the near-target route on the synthetic micro-scene and the
switch-policy route on a file-backed far-target fixture (2 grid scenes of
V = 12). Actions and distances must be equal, per-step STFT-L2 within 1e-4
relative (as tests/test_torch_eval.py holds the device evaluator) and
per-step SI-SDR within 0.05 dB where it is above -40 dB (below that the
metric is ill-conditioned). ``eval/bss.py`` is the JAX package's numpy,
copied: equal to the last bit. Then the trainer's routing: the host
evaluator below TPU.DEVICE_EVAL_MIN_EPISODES, over the bank budget and with
TPU.DEVICE_ENV off, the device evaluator otherwise, and file-backed data
resolved from the merged eval config (with VIDEO_OPTION disk)."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env import bundle as jb
from move2hear_tpu.env import environment as j_environment
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.eval import bss as jbss
from move2hear_tpu.eval.evaluator import evaluate_checkpoint as j_evaluate
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import bundle as tb
from move2hear_tpu_torch.env.layout import write_soundspaces_layout
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.eval import bss
from move2hear_tpu_torch.eval.evaluator import evaluate_checkpoint
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.utils.checkpoint import save_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID = 32
L2_KEYS = ("mono_l2_last", "mono_l2_all", "mem_l2_last", "mem_l2_all", "bin_l2_all")
NEAR, FAR = "configs/test/nearTarget.yaml", "configs/test/farTarget.yaml"


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """In a process with JAX loaded, the first call of a torch transcendental
    over a large CPU tensor sometimes returns one intra-op thread's chunk off
    by up to 1.5e-4 relative (ROADMAP, Queue 3); one call of each first."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


def _perturbed(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if k in ("mean", "bias"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "var":
            a = (0.5 + rng.uniform(0.0, 1.0, a.shape)).astype(np.float32)
        out[k] = a
    return out


def _weights(seed):
    policy = JPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=True)
    obs = {
        "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
        "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
        "target_class": jnp.zeros((1, 1), jnp.int32),
    }
    v = jax.jit(policy.init)(jax.random.PRNGKey(seed), obs, jnp.zeros((1, HID)), jnp.ones((1, 1)))
    rng = np.random.default_rng(seed)
    return _perturbed(v["params"], rng), _perturbed(v["batch_stats"], rng)


def _run_both(tmp, exp, opts, j_bundle, t_bundle, switch):
    """(JAX aggregates, port aggregates, JAX dump, port dump, JAX actions,
    port actions, port config)."""
    (p1, s1), (p2, s2) = _weights(1), _weights(2)
    j_actions, t_actions = {}, {}
    j_step = j_environment.AAViSSEnv.step

    def record(env, action):
        key = (env.current_episode.scene_id, env.current_episode.episode_id)
        j_actions.setdefault(key, []).append(int(action))
        return j_step(env, action)

    status, jpk._PALLAS_STATUS = jpk._PALLAS_STATUS, {}
    try:
        with jax.default_matmul_precision("highest"), pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_environment.AAViSSEnv, "step", record)
            jcfg = j_get_config(exp, opts, str(tmp / "jax"), "eval")
            j_ckpt = str(tmp / "jax" / "ckpt.0.pth")
            if switch:
                j_save_checkpoint(j_ckpt, {"params_nav": p1, "batch_stats_nav": s1,
                                           "params_qualImprov": p2, "batch_stats_qualImprov": s2,
                                           "config": {}})
            else:
                j_save_checkpoint(j_ckpt, {"params": p1, "batch_stats": s1, "config": {}})
            j_agg = j_evaluate(jcfg, j_ckpt, 0, bundle=j_bundle)
    finally:
        jpk._PALLAS_STATUS = status
    tcfg = get_config(exp, opts, str(tmp / "torch"), "eval")
    t_ckpt = str(tmp / "torch" / "ckpt.0.pth")
    if switch:
        save_checkpoint(t_ckpt, {"state_dict_nav": from_jax(p1, s1),
                                 "state_dict_qualImprov": from_jax(p2, s2),
                                 "config_nav": {}, "config_qualImprov": {}})
    else:
        save_checkpoint(t_ckpt, {"state_dict": from_jax(p1, s1), "config": {}})
    t_agg = evaluate_checkpoint(tcfg, t_ckpt, 0, bundle=t_bundle, device="cpu",
                                actions_out=t_actions)

    def dump(cfg):
        with open(os.path.join(cfg.MODEL_DIR, "eval_metrics_ckpt_0.pkl"), "rb") as f:
            return pickle.load(f)

    for ckpt in (j_ckpt, t_ckpt):
        os.remove(ckpt)  # a checkpoint takes 0.2-0.4 GB
    return j_agg, t_agg, dump(jcfg), dump(tcfg), j_actions, t_actions, tcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_eval")
    near_opts = ["RL.PPO.hidden_size", str(HID), "RL.PPO.deterministic_eval", "True",
                 "EVAL_EPISODE_COUNT", "2", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
                 "TPU.MAX_RIR_LENGTH", "400"]
    near = _run_both(tmp / "near", NEAR, near_opts,
                     j_build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400),
                     build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400), False)
    lay = write_soundspaces_layout(tmp / "layout", num_scenes=2, rows=3, cols=4,
                                   episodes_per_scene=1, rir_length=400,
                                   splits={"test_farTarget": False}, seed=2)
    far_opts = near_opts[:-4] + ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "4",
                                 "RL.PPO.time_thres_for_pol_switch", "2"] + lay["opts"]
    j_bundle = jb.bundle_from_config(j_get_config(FAR, far_opts, str(tmp), "eval").TASK_CONFIG,
                                     max_rir_length=400)
    t_bundle = tb.bundle_from_config(get_config(FAR, far_opts, str(tmp), "eval").TASK_CONFIG,
                                     max_rir_length=400)
    far = _run_both(tmp / "far", FAR, far_opts, j_bundle, t_bundle, True)
    return {"near": near, "switch": far}


@pytest.mark.parametrize("route", ["near", "switch"])
def test_host_eval_actions_and_aggregates_match_jax(runs, route):
    j_agg, t_agg, _, _, j_actions, t_actions, _ = runs[route]
    assert t_actions == j_actions and len(t_actions) == 2
    assert set(t_agg) == set(j_agg)
    for k in L2_KEYS:
        assert t_agg[k]["mean"] == pytest.approx(j_agg[k]["mean"], rel=1e-4), k
        assert t_agg[k]["std"] == pytest.approx(j_agg[k]["std"], rel=1e-3, abs=1e-7), k
    for k in t_agg:
        if "distance" in k:
            assert t_agg[k] == pytest.approx(j_agg[k], abs=1e-9), k


@pytest.mark.parametrize("route", ["near", "switch"])
def test_host_eval_dumps_match_jax(runs, route):
    """The per-episode, per-step pkl dump and the stats json, in the JAX
    package's layout."""
    _, _, j_dump, t_dump, _, _, tcfg = runs[route]
    assert set(t_dump) == set(j_dump)
    compared = 0
    for key, j_ep in j_dump.items():
        t_ep = t_dump[key]
        assert set(t_ep) == set(j_ep) == {"mono_l2", "mem_l2", "bin_l2", "quality"}
        for m in ("mono_l2", "mem_l2", "bin_l2"):
            np.testing.assert_allclose(t_ep[m], j_ep[m], rtol=1e-4, err_msg=m)
        assert len(t_ep["quality"]) == len(j_ep["quality"]) == len(j_ep["mono_l2"])
        for qt, qj in zip(t_ep["quality"], j_ep["quality"]):
            assert set(qt["mono"]) == set(qj["mono"]) == {"si_sdr"}
            for head in ("mono", "monoFromMem"):
                a, b = qt[head]["si_sdr"], qj[head]["si_sdr"]
                assert np.isfinite(a)
                if b > -40.0:
                    assert abs(a - b) < 0.05, (key, head, a, b)
                    compared += 1
    assert compared >= 4
    with open(os.path.join(tcfg.MODEL_DIR, f"{tcfg.EVAL.SPLIT}_stats_ckpt_0_0.json")) as f:
        stats = json.load(f)
    assert {"mono_l2_last", "geo_distance_to_target_audio_source", "geodesic_distance_1",
            "euclid_distance_to_target_audio_source"} <= set(stats)
    assert all(set(v) == {"mean", "std"} for v in stats.values())


def test_bss_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    mag, phase = np.abs(rng.standard_normal((512, 32))), rng.uniform(-3, 3, (512, 32))
    np.testing.assert_array_equal(bss.np_istft(mag, phase), jbss.np_istft(mag, phase))
    spects = {k: np.abs(rng.standard_normal((1, 512, 32, c))) for k, c in (
        ("mixed_bin_audio_mag", 2), ("gt_mono_mag", 1), ("pred_mono", 1), ("pred_monoFromMem", 1))}
    spects["mixed_bin_audio_phase"] = rng.uniform(-3, 3, (1, 512, 32, 2))
    spects["gt_mono_phase"] = rng.uniform(-3, 3, (1, 512, 32, 1))
    names = ["si_sdr", "si_sir", "si_sar", "sd_sdr", "snr", "srr", "si_sdri", "sd_sdri", "snri",
             "si_siri", "si_sari"]
    ours = bss.compute_waveform_quality(spects, names)
    ref = jbss.compute_waveform_quality(spects, names)
    assert ours == ref and len(ours["mono"]) == 11
    refs = rng.standard_normal((300, 2))
    est, mix = rng.standard_normal(300), rng.standard_normal(300)
    assert bss.scale_bss_eval(refs, est, mix, 0) == jbss.scale_bss_eval(refs, est, mix, 0)


def _ckpt(tmp_path, config):
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    path = str(tmp_path / "ckpt.0.pth")
    save_checkpoint(path, {"state_dict": policy.state_dict(), "config": config})
    return path


EVAL_SMALL = ["RL.PPO.hidden_size", str(HID), "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "2",
              "TPU.MAX_RIR_LENGTH", "400", "EVAL_EPISODE_COUNT", "2"]

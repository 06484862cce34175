"""The port's eval slice on the CPU: ``evaluate_checkpoint_device`` against
the JAX package's on the same micro-scene (3x3 grid, RIR length 400) with
the same weights (flax parameters through ``from_jax``), deterministic
actions, hidden 32, 2 envs and 3 steps. STFT-L2 aggregates must agree
within 1e-4 relative and the per-step SI-SDRs within 0.05 dB where the
SI-SDR is above -40 dB (below that the metric is ill-conditioned: the
residual energy sits at the float32 floor of the reference's). Then the
CLI entry point and the checkpoint-polling trainer run on the CPU."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.eval.device_evaluator import evaluate_checkpoint_device as j_evaluate
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.eval.device_evaluator import evaluate_checkpoint_device
from move2hear_tpu_torch.main import main
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.checkpoint import save_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/test/nearTarget.yaml"
HID = 32
L2_KEYS = ("mono_l2_last", "mono_l2_all", "mem_l2_last", "mem_l2_all", "bin_l2_all")


def _opts(hidden=HID):
    return [
        "RL.PPO.hidden_size", str(hidden),
        "RL.PPO.deterministic_eval", "True",
        "EVAL_EPISODE_COUNT", "2",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
    ]


def _perturbed(tree, rng):
    """Redraw BatchNorm statistics and biases so the weight maps carry
    non-trivial values."""
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


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval")
    with jax.default_matmul_precision("highest"):
        jcfg = j_get_config(EXP, _opts(), str(tmp / "jax"), "eval")
        policy = JPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=True)
        obs = {
            "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
            "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
            "target_class": jnp.zeros((1, 1), jnp.int32),
        }
        v = jax.jit(policy.init)(jax.random.PRNGKey(0), obs, jnp.zeros((1, HID)),
                                 jnp.ones((1, 1)))
        rng = np.random.default_rng(0)
        params, stats = _perturbed(v["params"], rng), _perturbed(v["batch_stats"], rng)
        j_ckpt = str(tmp / "jax" / "ckpt.0.pth")
        j_save_checkpoint(j_ckpt, {"params": params, "batch_stats": stats, "config": {}})
        j_bundle = j_build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400)
        j_agg = j_evaluate(jcfg, j_ckpt, 0, bundle=j_bundle, batch_envs=2)

    tcfg = get_config(EXP, _opts(), str(tmp / "torch"), "eval")
    t_ckpt = str(tmp / "torch" / "ckpt.0.pt")
    save_checkpoint(t_ckpt, {"state_dict": from_jax(params, stats), "config": {}})
    t_bundle = build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400)
    t_agg = evaluate_checkpoint_device(tcfg, t_ckpt, 0, bundle=t_bundle, batch_envs=2,
                                       device="cpu")

    def dump(cfg):
        with open(os.path.join(cfg.MODEL_DIR, "eval_metrics_ckpt_0.pkl"), "rb") as f:
            return pickle.load(f)

    return j_agg, t_agg, dump(jcfg), dump(tcfg), tcfg, t_ckpt


def test_slice_stft_l2_aggregates_match_jax(slice_run):
    j_agg, t_agg, *_ = slice_run
    assert set(t_agg) == set(j_agg)
    for k in L2_KEYS:
        assert t_agg[k]["mean"] == pytest.approx(j_agg[k]["mean"], rel=1e-4), k
    for k in t_agg:
        if "distance" in k:
            assert t_agg[k]["mean"] == pytest.approx(j_agg[k]["mean"], abs=1e-6), k


def test_slice_si_sdr_matches_jax(slice_run):
    _, _, j_dump, t_dump, *_ = slice_run
    assert set(t_dump) == set(j_dump) and len(t_dump) == 2
    compared = 0
    for key, j_ep in j_dump.items():
        t_ep = t_dump[key]
        np.testing.assert_allclose(t_ep["mono_l2"], j_ep["mono_l2"], rtol=1e-4)
        assert len(t_ep["quality"]) == len(j_ep["quality"]) == 3
        for qt, qj in zip(t_ep["quality"], j_ep["quality"]):
            for head in ("mono", "monoFromMem"):
                a, b = qt[head]["si_sdr"], qj[head]["si_sdr"]
                assert np.isfinite(a)
                if b > -40.0:
                    assert abs(a - b) < 0.05, (key, head, a, b)
                    compared += 1
    assert compared >= 6


def test_slice_writes_stats_in_the_jax_layout(slice_run):
    *_, tcfg, _ = slice_run
    with open(os.path.join(tcfg.MODEL_DIR, "test_nearTarget_stats_ckpt_0_0.json")) as f:
        stats = json.load(f)
    assert {"mono_l2_last", "monoFromMem_si_sdri_last", "geodesic_distance_1",
            "euclidean_distance_0"} <= set(stats)
    assert all(set(v) == {"mean", "std"} for v in stats.values())


def _small_cli_opts(ckpt):
    return [
        "EVAL_CKPT_PATH_DIR", ckpt,
        "EVAL_EPISODE_COUNT", "2",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "2",
        "TPU.DEVICE_EVAL_MIN_EPISODES", "2",
        "TPU.MAX_RIR_LENGTH", "400",
    ]


def test_cli_eval_on_cpu_uses_the_checkpoints_own_opts(tmp_path):
    """main --run-type eval on the CPU; the checkpoint was trained with
    ``RL.PPO.hidden_size 32`` as a CLI override, which the eval config merge
    must apply (the eval YAML says 512)."""
    torch.manual_seed(0)
    policy = Move2HearPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=True)
    ckpt = str(tmp_path / "ckpt.7.pt")
    save_checkpoint(ckpt, {
        "state_dict": policy.state_dict(),
        "config": {"CMD_TRAILING_OPTS": ["RL.PPO.hidden_size", str(HID)]},
    })
    kernels.reset_launch_counts()
    trainer = main(["--run-type", "eval", "--exp-config", EXP, "--model-dir",
                    str(tmp_path), "--device", "cpu", *_small_cli_opts(ckpt)])
    agg, timings = trainer.last_eval
    assert np.isfinite(agg["mono_si_sdr_last"]["mean"])
    assert timings["episodes"] == 2 and timings["env_steps"] == 2 * 2
    assert os.path.exists(tmp_path / "test_nearTarget_stats_ckpt_0_0.json")
    # CPU tensors take the plain versions: no kernel launched
    assert kernels.launch_counts() == {
        "masked_mix_slice16": 0, "overlap_add": 0, "masked_mix_slice16_bwd": 0,
    }


def test_trainer_polls_a_checkpoint_folder(tmp_path):
    torch.manual_seed(1)
    policy = Move2HearPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=True)
    folder = tmp_path / "data"
    save_checkpoint(str(folder / "ckpt.0.pt"), {"state_dict": policy.state_dict(), "config": {}})
    cfg = get_config(EXP, ["RL.PPO.hidden_size", str(HID), "RL.PPO.deterministic_eval", "False",
                           *_small_cli_opts(str(folder))[2:]], str(tmp_path), "eval")
    trainer = PPOTrainer(cfg, device="cpu")
    trainer._eval_poll_once = True
    trainer.eval()
    assert os.path.exists(tmp_path / "test_nearTarget_stats_ckpt_0_0.json")
    # sampled actions come from a generator seeded by cfg.SEED: reproducible
    first = trainer.last_eval[0]
    again = PPOTrainer(cfg, device="cpu")
    again._eval_checkpoint(str(folder / "ckpt.0.pt"), 1)
    assert again.last_eval[0] == first

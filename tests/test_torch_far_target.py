"""The port's far-target task on the CPU against the JAX package: the env's
navigation reward, the far-target collect (navigation rewards), two
far-target training cycles, and the switch-policy evaluation of a merged
checkpoint.

Small sizes as tests/test_torch_train_loop.py: 3x3 far-target micro-scene
(RIR length 400), 2 to 4 envs, hidden 32, short horizons.
Weights are flax parameters drawn from a seed, fed to both packages
(``utils/params.py:from_jax``). Distances and navigation rewards are integer
steps times the grid size in float32, so they must be equal; per-env values
that average over spectrograms agree within 1e-4 relative (``_close``), and
the eval within the tolerances of tests/test_torch_eval.py (STFT-L2 1e-4
relative, distances 1e-6, SI-SDR 0.05 dB above -40 dB)."""

import functools
import glob
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env import device_env as jde
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.eval import device_evaluator as jdev
from move2hear_tpu.eval.evaluator import merge_switch_policy_checkpoint as j_merge
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.eval.device_evaluator import setup_device_eval
from move2hear_tpu_torch.eval.switch import merge_switch_policy_checkpoint
from move2hear_tpu_torch.main import main
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.rl import device_rollout as tdr
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.rl import trainer as trainer_mod
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from move2hear_tpu_torch.utils.tb import TensorboardWriter
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, MAX_STEPS, GT_NORM = 32, 4, 6, 4, 1.2
CODES = (1, 2, 3)  # MOVE_FORWARD, TURN_LEFT, TURN_RIGHT
SENSORS = ("mixed_bin_audio_mag", "target_class", "rgb", "depth")
TRAIN_EXP = "configs/train/farTarget.yaml"
EVAL_EXP = "configs/test/farTarget.yaml"
EVAL_STEPS, SWITCH_AT = 4, 2
L2_KEYS = ("mono_l2_last", "mono_l2_all", "mem_l2_last", "mem_l2_all", "bin_l2_all")


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """One call of each torch transcendental over a large CPU tensor first:
    in a process with JAX loaded the first one can return one thread's chunk
    off by up to 1.5e-4 (ROADMAP, Queue 3)."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


@pytest.fixture(autouse=True)
def _jax_cpu_route():
    """The JAX package's plain CPU route: no Pallas status recorded by an
    interpret-mode call elsewhere in the process (ROADMAP, Queue 3)."""
    status, jpk._PALLAS_STATUS = jpk._PALLAS_STATUS, {}
    with jax.default_matmul_precision("highest"):
        yield
    jpk._PALLAS_STATUS = status


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


@functools.lru_cache(maxsize=None)
def _jax_init(hidden):
    """The JAX policy and its init, compiled once for every seed."""
    policy = JPolicy(num_actions=3, hidden_size=hidden, extra_depth=True, use_ddppo=True)
    return policy, jax.jit(policy.init)


def _jax_weights(hidden, seed):
    policy, init = _jax_init(hidden)
    obs = {
        "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
        "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
        "target_class": jnp.zeros((1, 1), jnp.int32),
    }
    v = init(jax.random.PRNGKey(seed), obs, jnp.zeros((1, hidden)), jnp.ones((1, 1)))
    rng = np.random.default_rng(seed)
    return policy, _perturbed(v["params"], rng), _perturbed(v["batch_stats"], rng)


def _close(ours, ref, msg):
    ours = ours.to(torch.float32).numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(), err_msg=msg)


def test_env_step_nav_reward_equals_jax_over_far_episodes():
    j_bundle = j_build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=300,
                                   near_target=False)
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=300,
                               near_target=False)
    j_dev = jde.build_device_bundle(j_bundle)
    dev = de.build_device_bundle(bundle, "cpu")
    n_envs, max_steps, steps = 4, 5, 13  # two resets inside the run
    order = jde.make_order_table(n_envs, 8, 3)
    j_state = jde.env_reset_all(j_dev.scene, j_dev.episodes, jnp.asarray(order))
    state = de.env_reset_all(dev.scene, dev.episodes, torch.as_tensor(order))
    np.testing.assert_array_equal(state.prev_geo.numpy(), np.asarray(j_state.prev_geo))
    assert (state.prev_geo >= 2.0).all()  # far episodes start two steps away or more
    actions = np.random.default_rng(0).choice([1, 1, 2, 3], size=(steps, n_envs))
    nav = []
    for t in range(steps):
        j_state, j_info = jde.env_step(j_dev.scene, j_dev.episodes, j_state,
                                       jnp.asarray(actions[t], jnp.int32), max_steps)
        state, info = de.env_step(dev.scene, dev.episodes, state,
                                  torch.as_tensor(actions[t]), max_steps)
        for k in ("nav_reward", "geo", "done"):
            np.testing.assert_array_equal(info[k].numpy(), np.asarray(j_info[k]), err_msg=k)
        for k in ("node", "rot", "ep", "prev_geo"):
            np.testing.assert_array_equal(getattr(state, k).numpy(),
                                          np.asarray(getattr(j_state, k)), err_msg=k)
        assert info["nav_reward"].dtype == torch.float32
        nav.append(info["nav_reward"].numpy())
    nav = np.stack(nav)
    assert (nav > 0).any() and (nav < 0).any()


@pytest.fixture(scope="module")
def far_collected():
    """(JAX far-target collect as numpy, the port's, replaying JAX's actions)."""
    status, jpk._PALLAS_STATUS = jpk._PALLAS_STATUS, {}
    with jax.default_matmul_precision("highest"):
        j_policy, params, stats = _jax_weights(HID, 0)
        j_bundle = j_build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=400,
                                       near_target=False)
        j_dev = jde.build_device_bundle(j_bundle, precompute_rir_rfft=True)
        order = jde.make_order_table(N, 8, 0)
        j_env = jde.env_reset_all(j_dev.scene, j_dev.episodes, jnp.asarray(order))
        collect = jdr.make_collect(j_policy, jppo.PPOConfig(), T, MAX_STEPS, GT_NORM, False,
                                   10.0, 1.0, CODES, SENSORS)
        out = jax.jit(collect)(j_dev, params, stats, j_env, jnp.zeros((N, HID)),
                               jnp.ones((N, 1)), jnp.zeros((N, 512, 32, 1)),
                               jax.random.PRNGKey(1))
        j_out = jax.tree.map(np.asarray, (out.rollouts_pol, out.stats))
    jpk._PALLAS_STATUS = status

    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    policy.load_state_dict(from_jax(params, stats))
    policy.eval()
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=400, near_target=False)
    dev = de.build_device_bundle(bundle, "cpu", precompute_rir_rfft=True)
    env = de.env_reset_all(dev.scene, dev.episodes, torch.as_tensor(order))
    actions = torch.tensor(j_out[0]["actions"], dtype=torch.long)
    collect = tdr.make_collect(policy, tppo.PPOConfig(), T, MAX_STEPS, GT_NORM, 10.0, CODES,
                               SENSORS, sampler=lambda dist, t: actions[t],
                               sep_rewards=False, nav_reward_scale=1.0)
    ours = collect(dev, env, torch.zeros((N, HID)), torch.ones((N, 1)),
                   torch.zeros((N, 512, 32, 1)))
    return j_out, ours


def test_far_collect_rewards_equal_jax_and_returns_match(far_collected):
    (j_pol, j_stats), ours = far_collected
    pol = ours.rollouts_pol
    np.testing.assert_array_equal(pol["actions"].numpy(), j_pol["actions"])
    np.testing.assert_array_equal(pol["masks"].numpy(), j_pol["masks"])
    assert j_pol["masks"].min() == 0.0  # an episode ends inside the rollout
    np.testing.assert_array_equal(pol["rewards"].numpy(), j_pol["rewards"])
    assert (j_pol["rewards"] != 0).any()
    for k in ("value_preds", "returns", "action_log_probs", "hidden"):
        _close(pol[k], j_pol[k], k)
    st, j_st = tdr.unpack_stats(ours.stats), tdr.unpack_stats(j_stats)
    np.testing.assert_array_equal(st["reward"].numpy(), j_st["reward"])
    np.testing.assert_array_equal(st["geo"].numpy(), j_st["geo"])
    for k in st:
        _close(st[k], j_st[k], k)


def _train_opts(updates):
    return [
        "NUM_PROCESSES", "2", "NUM_UPDATES", str(updates), "CHECKPOINT_INTERVAL", "100",
        "LOG_INTERVAL", "2", "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", "4",
        "RL.PPO.num_updates_per_cycle", "1", "RL.PPO.ppo_epoch", "2",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(MAX_STEPS),
    ]


def test_two_far_target_cycles_train_and_write_a_checkpoint(tmp_path, monkeypatch):
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=400,
                               near_target=False)
    cfg = get_config(TRAIN_EXP, _train_opts(2), str(tmp_path / "run"), "train")
    assert (cfg.RL.PPO.sep_reward_weight, cfg.RL.PPO.nav_reward_weight) == (0.0, 1.0)
    seen = []

    def recording_collect(*a, **kw):
        seen.append((kw["sep_rewards"], kw["nav_reward_scale"]))
        return tdr.make_collect(*a, **kw)

    monkeypatch.setattr(trainer_mod, "make_collect", recording_collect)
    # the writer that logs nothing: importing TensorBoard (and TensorFlow with
    # it) takes longer than the two cycles, and the logs are not checked here
    monkeypatch.setattr(trainer_mod, "TensorboardWriter", lambda *a, **kw: TensorboardWriter(""))
    trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
    trainer.train()
    assert seen == [(False, 1.0)]  # navigation rewards, RL.DISTANCE_REWARD_SCALE
    assert len(trainer.cycle_log) == 2 and len(trainer.loss_log) == 2
    for pol, sep in trainer.loss_log:
        assert np.isfinite(pol).all() and np.isfinite(sep).all()
    ckpt = load_checkpoint(os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2.pth"))
    assert ckpt["extra_state"]["update_count"] == 2
    assert ckpt["config"]["RL"]["PPO"]["nav_reward_weight"] == 1.0
    fresh = trainer._new_policy().state_dict()
    for k, v in ckpt["state_dict"].items():
        moved = not torch.equal(v, fresh[k])
        assert moved == (k.split(".")[0] in tppo.POL_KEYS + tppo.SEP_TRAIN_KEYS), k
    shutil.rmtree(tmp_path / "run")  # the checkpoints take a few hundred MB


def _eval_opts(extra=()):
    return [
        "RL.PPO.deterministic_eval", "True", "RL.PPO.time_thres_for_pol_switch", str(SWITCH_AT),
        "EVAL_EPISODE_COUNT", "2", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(EVAL_STEPS),
        "TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_RIR_LENGTH", "400", *extra,
    ]


@pytest.fixture(scope="module")
def switch_run(tmp_path_factory):
    """The same two policies (seeds 1 and 2) merged into a switch checkpoint
    by each package and evaluated with configs/test/farTarget.yaml: the JAX
    device evaluator, and the port's eval CLI, whose nav checkpoint carries
    the hidden size in its own config (so the switch eval must read
    ``config_nav``)."""
    tmp = tmp_path_factory.mktemp("far_eval")
    status, jpk._PALLAS_STATUS = jpk._PALLAS_STATUS, {}
    with jax.default_matmul_precision("highest"):
        jcfg = j_get_config(EVAL_EXP, _eval_opts(["RL.PPO.hidden_size", str(HID)]),
                            str(tmp / "jax"), "eval")
        weights = {}
        for role, seed in (("nav", 1), ("qi", 2)):
            _, params, stats = _jax_weights(HID, seed)
            weights[role] = (params, stats)
            j_save_checkpoint(str(tmp / "jax" / f"{role}.pth"),
                              {"params": params, "batch_stats": stats, "config": {}})
        j_switch = j_merge(str(tmp / "jax" / "nav.pth"), str(tmp / "jax" / "qi.pth"),
                           str(tmp / "jax" / "switch.pth"))
        j_agg = jdev.evaluate_checkpoint_device(jcfg, j_switch, 0)
        # the per-step distances and the final poses of the first batch, from
        # the program the evaluator compiled
        (bundle_j, dev_j, fn_j), = jdev._EVAL_PROGRAM_CACHE.values()
        j_state0 = jde.env_reset_all(dev_j.scene, dev_j.episodes,
                                     jnp.asarray([[0], [1]], jnp.int32))
        j_end, _, j_outs = fn_j(dev_j, *weights["nav"], *weights["qi"], j_state0,
                                jax.random.split(jax.random.PRNGKey(jcfg.SEED))[1])
        j_traj = {"geo": np.asarray(j_outs["geo"]),
                  **{k: np.asarray(getattr(j_end, k)) for k in ("node", "rot", "prev_geo")}}
    jpk._PALLAS_STATUS = status

    hid_opts = ["RL.PPO.hidden_size", str(HID)]
    for role in ("nav", "qi"):
        save_checkpoint(str(tmp / "torch" / f"{role}.pth"), {
            "state_dict": from_jax(*weights[role]),
            "config": {"CMD_TRAILING_OPTS": hid_opts} if role == "nav" else {},
        })
    t_switch = merge_switch_policy_checkpoint(str(tmp / "torch" / "nav.pth"),
                                              str(tmp / "torch" / "qi.pth"),
                                              str(tmp / "torch" / "switch.pth"))
    kernels.reset_launch_counts()
    ev = main(["--run-type", "eval", "--exp-config", EVAL_EXP, "--model-dir",
               str(tmp / "torch"), "--device", "cpu", "EVAL_CKPT_PATH_DIR", t_switch,
               *_eval_opts()])
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    tcfg = get_config(EVAL_EXP, _eval_opts(hid_opts), str(tmp / "torch"), "eval")
    setup = setup_device_eval(tcfg, load_checkpoint(t_switch), device="cpu",
                              batch_envs=2)
    state0 = de.env_reset_all(setup.dev.scene, setup.dev.episodes, torch.tensor([[0], [1]]))
    with torch.inference_mode():
        end, _, outs = setup.eval_fn(setup.dev, state0, None)
    traj = {"geo": outs["geo"].numpy(), "action": outs["action"].numpy(),
            **{k: getattr(end, k).numpy() for k in ("node", "rot", "prev_geo")}}

    def dump(model_dir):
        with open(os.path.join(model_dir, "eval_metrics_ckpt_0.pkl"), "rb") as f:
            return pickle.load(f)

    merged = load_checkpoint(t_switch)
    layout = {"keys": set(merged), "config_nav": merged["config_nav"],
              **{role: (set(merged[f"state_dict_{role}"]),
                        merged[f"state_dict_{role}"]["critic.fc.weight"])
                 for role in ("nav", "qualImprov")}}
    for path in glob.glob(str(tmp / "*" / "*.pth")):
        os.remove(path)  # six checkpoints of about 130 MB each
    return (j_agg, dump(str(tmp / "jax")), j_traj, ev.last_eval[0], dump(str(tmp / "torch")),
            traj, layout)


def test_merged_switch_checkpoint_has_the_reference_layout(switch_run):
    layout = switch_run[-1]
    assert layout["keys"] == {"state_dict_nav", "config_nav", "state_dict_qualImprov",
                              "config_qualImprov"}
    assert layout["config_nav"]["CMD_TRAILING_OPTS"] == ["RL.PPO.hidden_size", str(HID)]
    (nav_keys, nav_critic), (qi_keys, qi_critic) = layout["nav"], layout["qualImprov"]
    assert nav_keys == qi_keys and not torch.equal(nav_critic, qi_critic)


def test_switch_eval_trajectories_equal_jax(switch_run):
    _, _, j_traj, _, _, traj, _ = switch_run
    assert traj["geo"].shape == (EVAL_STEPS, 2)
    for k in ("geo", "node", "rot", "prev_geo"):
        np.testing.assert_array_equal(traj[k], j_traj[k], err_msg=k)
    # both policies acted: the deterministic actions before and after the switch
    assert traj["action"].shape == (EVAL_STEPS, 2)


def test_switch_eval_metrics_match_jax(switch_run):
    j_agg, j_dump, _, t_agg, t_dump, _, _ = switch_run
    assert set(t_agg) == set(j_agg)
    assert {"geodesic_distance_0", "euclidean_distance_0",
            "geo_distance_to_target_audio_source"} <= set(t_agg)
    for k in L2_KEYS:
        assert t_agg[k]["mean"] == pytest.approx(j_agg[k]["mean"], rel=1e-4), k
    for k in t_agg:
        if "distance" in k:
            assert t_agg[k]["mean"] == pytest.approx(j_agg[k]["mean"], abs=1e-6), k
    assert set(t_dump) == set(j_dump) and len(t_dump) == 2
    compared = 0
    for key, j_ep in j_dump.items():
        t_ep = t_dump[key]
        for k in ("mono_l2", "mem_l2", "bin_l2"):
            np.testing.assert_allclose(t_ep[k], j_ep[k], rtol=1e-4, err_msg=k)
        assert len(t_ep["quality"]) == len(j_ep["quality"]) == EVAL_STEPS
        for qt, qj in zip(t_ep["quality"], j_ep["quality"]):
            for head in ("mono", "monoFromMem"):
                a, b = qt[head]["si_sdr"], qj[head]["si_sdr"]
                assert np.isfinite(a)
                if b > -40.0:
                    assert abs(a - b) < 0.05, (key, head, a, b)
                    compared += 1
    assert compared >= 4

"""The port's rollout collection and training loop on the CPU: one
``make_collect`` against the JAX package's on the same micro-scene (3x3
grid, RIR length 400, 2 envs, 4 steps across an episode end, hidden 64)
with the same weights, replaying JAX's sampled actions; then two cycles of
``PPOTrainer.train()`` whose checkpoint the port's evaluator runs and a
resumed run reads. Spectrograms element by element carry the render's f16
casts and int16 rounding flips, so they agree within the render's
tolerance of tests/test_torch_kernels.py (rtol 2e-3, atol 2e-4); per-env
values that average over them (rewards, values, returns, log-probs, the
logging stats) agree within 1e-4 relative, as the STFT-L2 aggregates of
tests/test_torch_eval.py (atol 1e-4 of the largest |value|)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.env import device_env as jde
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.main import main
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.rl import device_rollout as tdr
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.rl.trainer import PPOTrainer, refuse_unported_knobs
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from move2hear_tpu_torch.utils.params import from_jax

HID, N, T, MAX_STEPS, GT_NORM = 64, 2, 4, 3, 1.2
CODES = (1, 2, 3)  # MOVE_FORWARD, TURN_LEFT, TURN_RIGHT
SENSORS = ("mixed_bin_audio_mag", "target_class", "rgb", "depth")
EXP = "configs/train/nearTarget.yaml"


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """In a process with JAX loaded, the first call of a torch transcendental
    over a large CPU tensor sometimes returns one intra-op thread's chunk off
    by up to 1.5e-4 relative (ROADMAP, Queue 3); later calls are exact. One
    call of each before the comparisons."""
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


@pytest.fixture(scope="module")
def collected():
    """(JAX CollectOutput as numpy, the port's CollectOutput)."""
    # the JAX package's CPU route: no Pallas status recorded by an earlier
    # interpret-mode call of the same process
    status, jpk._PALLAS_STATUS = jpk._PALLAS_STATUS, {}
    with jax.default_matmul_precision("highest"):
        j_policy = JPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=True)
        obs = {
            "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
            "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
            "target_class": jnp.zeros((1, 1), jnp.int32),
        }
        v = jax.jit(j_policy.init)(jax.random.PRNGKey(0), obs, jnp.zeros((1, HID)),
                                   jnp.ones((1, 1)))
        rng = np.random.default_rng(0)
        params, stats = _perturbed(v["params"], rng), _perturbed(v["batch_stats"], rng)
        j_bundle = j_build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400)
        j_dev = jde.build_device_bundle(j_bundle, precompute_rir_rfft=True)
        order = jde.make_order_table(N, 4, 0)
        j_env = jde.env_reset_all(j_dev.scene, j_dev.episodes, jnp.asarray(order))
        collect = jdr.make_collect(j_policy, jppo.PPOConfig(), T, MAX_STEPS, GT_NORM, True,
                                   10.0, 0.0, CODES, SENSORS)
        out = jax.jit(collect)(j_dev, params, stats, j_env, jnp.zeros((N, HID)),
                               jnp.ones((N, 1)), jnp.zeros((N, 512, 32, 1)),
                               jax.random.PRNGKey(1))
        j_out = jax.tree.map(np.asarray, (out.rollouts_pol, out.stats, out.sep_slab))
    jpk._PALLAS_STATUS = status

    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    policy.load_state_dict(from_jax(params, stats))
    policy.eval()
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400)
    dev = de.build_device_bundle(bundle, "cpu", precompute_rir_rfft=True)
    env = de.env_reset_all(dev.scene, dev.episodes,
                           torch.as_tensor(de.make_order_table(N, 4, 0)))
    actions = torch.tensor(j_out[0]["actions"], dtype=torch.long)
    collect = tdr.make_collect(policy, tppo.PPOConfig(), T, MAX_STEPS, GT_NORM, 10.0, CODES,
                               SENSORS, sampler=lambda dist, t: actions[t])
    ours = collect(dev, env, torch.zeros((N, HID)), torch.ones((N, 1)),
                   torch.zeros((N, 512, 32, 1)))
    return j_out, ours


def _close(ours, ref, msg, spectrogram=False):
    ours = ours.to(torch.float32).numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    if spectrogram:
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-4, err_msg=msg)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=msg)


SPECTROGRAMS = ("pred_binSepMasks", "pred_mono", "prev_pred_monoFromMem", "mixed_bin_audio_mag",
                "gt_mono", "prev_mem")


def test_collect_matches_jax_rollout(collected):
    (j_pol, _, _), ours = collected
    pol = ours.rollouts_pol
    np.testing.assert_array_equal(pol["actions"].numpy(), j_pol["actions"])
    np.testing.assert_array_equal(pol["masks"].numpy(), j_pol["masks"])
    assert j_pol["masks"].min() == 0.0  # the horizon ends inside the rollout
    for k in ("rewards", "value_preds", "returns", "action_log_probs", "hidden",
              "pred_binSepMasks", "pred_mono", "prev_pred_monoFromMem"):
        _close(pol[k], j_pol[k], k, k in SPECTROGRAMS)
    assert set(pol["observations"]) == set(j_pol["observations"])
    for k, v in pol["observations"].items():
        _close(v, j_pol["observations"][k], k, k in SPECTROGRAMS)


def test_collect_matches_jax_stats_and_sep_slab(collected):
    (_, j_stats, j_slab), ours = collected
    assert ours.stats.shape == j_stats.shape == (T, N, len(tdr.STAT_FIELDS) + 3)
    st, j_st = tdr.unpack_stats(ours.stats), tdr.unpack_stats(j_stats)
    for k in st:
        _close(st[k], j_st[k], k)
    # the bonus step (MAX-2) and the episode end both fall inside the rollout
    assert (j_st["done"] == 1.0).any()
    for k, v in ours.sep_slab.items():
        _close(v, j_slab[k], k, k in SPECTROGRAMS)


def _train_opts(updates):
    return [
        "NUM_PROCESSES", str(N), "NUM_UPDATES", str(updates), "CHECKPOINT_INTERVAL", "2",
        "LOG_INTERVAL", "2", "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", str(T),
        "RL.PPO.num_updates_per_cycle", "2", "RL.PPO.ppo_epoch", "2",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(MAX_STEPS),
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", str(GT_NORM),
    ]


def test_two_cycles_train_checkpoint_evaluate_and_resume(tmp_path):
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=400)
    cfg = get_config(EXP, _train_opts(4), str(tmp_path / "run"), "train")
    kernels.reset_launch_counts()
    trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
    trainer.train()
    # CPU tensors take the plain versions
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    assert len(trainer.cycle_log) == 2 and len(trainer.loss_log) == 2
    for pol, sep in trainer.loss_log:
        assert pol.shape == (2, 3) and sep.shape == (2, 3)
        assert np.isfinite(pol).all() and np.isfinite(sep).all()
    # CHECKPOINT_INTERVAL 2 = one cycle: after each cycle, and the final one
    assert sorted(os.listdir(cfg.CHECKPOINT_FOLDER)) == ["ckpt.0.pth", "ckpt.1.pth", "ckpt.2.pth"]
    ckpt_path = os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2.pth")
    ckpt = load_checkpoint(ckpt_path)
    assert ckpt["extra_state"]["update_count"] == 4
    assert set(ckpt) == {"state_dict", "config", "optimizer_pol", "optimizer_sep", "extra_state"}
    # 2 cycles x 2 updates x 2 epochs Adam steps; the sep group 2 x 2 x 2 refit steps
    assert int(ckpt["optimizer_pol"]["state"][0]["step"]) == 8
    assert int(ckpt["optimizer_sep"]["state"][0]["step"]) == 8
    # the frozen passive separators did not move
    fresh = trainer._new_policy().state_dict()
    for k, v in ckpt["state_dict"].items():
        moved = not torch.equal(v, fresh[k])
        assert moved == (k.split(".")[0] in tppo.POL_KEYS + tppo.SEP_TRAIN_KEYS), k

    # the port's evaluator runs the checkpoint it wrote
    ev = main(["--run-type", "eval", "--exp-config", "configs/test/nearTarget.yaml",
               "--model-dir", str(tmp_path / "eval"), "--device", "cpu",
               "EVAL_CKPT_PATH_DIR", ckpt_path, "EVAL_EPISODE_COUNT", "2",
               "TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_RIR_LENGTH", "400"])
    agg, timings = ev.last_eval
    assert timings["episodes"] == 2
    assert all(np.isfinite(agg[k]["mean"]) for k in ("mono_l2_last", "mem_l2_last", "bin_l2_all"))

    # an explicit RESUME_CKPT restores weights, both optimizers and the count
    cfg2 = get_config(EXP, _train_opts(6) + ["RESUME_CKPT", ckpt_path],
                      str(tmp_path / "resumed"), "train")
    again = PPOTrainer(cfg2, bundle=bundle, device="cpu")
    again.train()
    assert len(again.cycle_log) == 1
    last = load_checkpoint(os.path.join(cfg2.CHECKPOINT_FOLDER, "ckpt.1.pth"))
    assert last["extra_state"]["update_count"] == 6
    assert int(last["optimizer_pol"]["state"][0]["step"]) == 12


def test_chip_smoke_train_phases_run_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's train, far-train, switch merge and far-eval,
    switch-parity and train-parity phases, small and on the CPU (both
    devices the CPU), so their own logic is tested before a card runs
    them."""
    import chip_smoke

    run_dir = str(tmp_path / "smoke")
    os.makedirs(run_dir)
    opts = ["NUM_PROCESSES", str(N), "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", str(T),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(MAX_STEPS),
            "TPU.MAX_RIR_LENGTH", "400", "EVAL_EPISODE_COUNT", "2",
            "TPU.DEVICE_EVAL_MIN_EPISODES", "2"]
    zero = dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    counts, near_ckpt, _ = chip_smoke.train_phase(torch, kernels, "cpu", run_dir,
                                                  device="cpu", opts=opts, launches=zero)
    assert counts == zero
    chip_smoke.train_eval_phase(run_dir, near_ckpt, device="cpu", opts=opts)
    far_counts, far_ckpt, far_trainer = chip_smoke.train_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "far"), label="far-train",
        exp=chip_smoke.FAR_TRAIN_EXP, device="cpu", opts=opts, launches=zero)
    assert far_counts == zero and far_ckpt != near_ckpt
    chip_smoke.require_nav_rewards(far_trainer)
    assert load_checkpoint(far_ckpt)["config"]["RL"]["PPO"]["nav_reward_weight"] == 1.0
    eval_counts = chip_smoke.far_eval_phase(
        torch, kernels, "cpu", run_dir, far_ckpt, near_ckpt, device="cpu", launches=zero,
        episodes=2, opts=["EVAL_EPISODE_COUNT", "2", "TPU.DEVICE_EVAL_MIN_EPISODES", "2",
                          "TPU.MAX_RIR_LENGTH", "400", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS",
                          "4", "RL.PPO.time_thres_for_pol_switch", "2"])
    assert eval_counts == zero
    chip_smoke.parity_phase(torch, switch=True, devices=("cpu", "cpu"), n_envs=2, hid=HID)
    # scale-train on a 2-scene fixture under a budget between its sub-bank
    # and its dense banks, so that the gate chooses the sub-banks
    from move2hear_tpu_torch.env.micro_scene import build_scale_fixture
    from move2hear_tpu_torch.env.sub_bank import estimate_sub_bank_bytes

    small = dict(num_scenes=2, rows=3, cols=4, episodes_per_scene=6, rir_length=400,
                 with_frames=True)
    fixture = build_scale_fixture(**small)
    budget = (estimate_sub_bank_bytes(fixture, N, 2, T, MAX_STEPS)
              + de.estimate_bank_bytes(fixture)) // 2
    assert estimate_sub_bank_bytes(fixture, N, 2, T, MAX_STEPS) < budget < de.estimate_bank_bytes(fixture)
    scale_counts = chip_smoke.scale_train_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "scale"), device="cpu",
        opts=opts + ["TPU.MAX_DEVICE_BANK_BYTES", str(budget)], launches=zero, fixture=small)
    assert scale_counts == zero
    chip_smoke.scale_parity_phase(torch, os.path.join(run_dir, "scale_parity"), device="cpu",
                                  opts=opts, fixture=small, t=MAX_STEPS, n=N, hid=HID)
    chip_smoke.train_parity_phase(torch, devices=("cpu", "cpu"), t=T, n=N, hid=HID)
    out = capsys.readouterr().out
    assert "cycle 1 (warm)" in out and "eval of ckpt.2.pth" in out and "[train-parity]" in out
    assert "[far-train] cycle 1 (warm)" in out and "far-train-path launches" in out
    assert "merged ckpt.2.pth (navigation)" in out and "[far-eval] run warm" in out
    assert "switch at step 2" in out and "[switch-parity]" in out
    assert "[scale-train] cycle 1 (warm)" in out and "scale-train-path launches" in out
    assert "bitwise equal to the rows assembled anew" in out
    assert "mixture magnitudes bitwise equal" in out and "parameters bitwise equal" in out
    assert "slab gathers bitwise equal to dense at every step" in out
    shutil.rmtree(run_dir)


# The JAX package's TPU knobs the port does not honour: each is refused
# (ROADMAP Queue 1 item 5b; a mesh above one device, by the port's one
# rank per device), never run as if unset.
KNOBS_REFUSED_BY_EVAL = [
    ["TPU.MESH_SHAPE", "[2]"],
]
# The dtype knobs and REPORT_MFU, ported in item 5a: accepted (a short run),
# and a dtype the knob does not take raises ValueError.
KNOBS_PORTED = [
    ["TPU.COMPUTE_DTYPE", "bfloat16"],
    ["TPU.SEP_SLAB_DTYPE", "bfloat16"],
    ["TPU.SEP_REFIT_DTYPE", "bfloat16"],
    ["TPU.SUB_BANK_DTYPE", "bfloat16"],
]


@pytest.mark.parametrize("opts,env", [
    *[(o, {}) for o in KNOBS_REFUSED_BY_EVAL],
    (["TPU.FUSED_CYCLE", "True"], {}),
    (["TPU.PAIRWISE_FUSION", "True"], {}),
    (["TPU.COLLECT_UNROLL", "4"], {}),
    (["RL.PPO.nav_reward_weight", "0.5", "RL.PPO.sep_reward_weight", "0.5"], {}),
])
def test_train_refuses_the_routes_not_ported(tmp_path, monkeypatch, opts, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = get_config(EXP, _train_opts(4) + opts, str(tmp_path), "train")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item|reward|one rank per"):
        PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=400),
                   device="cpu").train()
    assert not os.path.exists(cfg.CHECKPOINT_FOLDER)  # refused before any training


@pytest.mark.parametrize("opts", [
    ["TPU.RIR_MODE", "host"],
    ["TPU.DEVICE_ENV", "False"],
    # the dense banks and the sub-bank both over the budget
    ["TPU.MAX_DEVICE_BANK_BYTES", "1000"],
], ids=["RIR_MODE_host", "DEVICE_ENV_False", "banks_over_budget"])
def test_train_takes_the_host_route(tmp_path, opts):
    """RIR_MODE host and DEVICE_ENV False force the host env path, and
    under RIR_MODE auto the gate takes it when both bank estimates exceed
    TPU.MAX_DEVICE_BANK_BYTES; one cycle trains and checkpoints."""
    cfg = get_config(EXP, _train_opts(2) + ["USE_SYNC_VECENV", "True"] + opts, str(tmp_path),
                     "train")
    trainer = PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                       rir_length=400), device="cpu")
    trainer.train()
    assert trainer._rir_mode == "host" and len(trainer.cycle_log) == 1
    pol, sep = trainer.loss_log[0]
    assert np.isfinite(pol).all() and np.isfinite(sep).all()
    assert os.path.exists(os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.1.pth"))
    shutil.rmtree(cfg.CHECKPOINT_FOLDER)  # 0.4 GB


@pytest.mark.parametrize("opts,rows", [
    (["TPU.RIR_MODE", "sub"], None),
    (["TPU.RIR_MODE", "sub", "TPU.SUB_BANK_ROWS", "64"], 64),
], ids=["RIR_MODE_sub", "SUB_BANK_ROWS_64"])
def test_train_runs_the_sub_bank_route(tmp_path, opts, rows):
    """RIR_MODE sub, with SUB_BANK_ROWS slots or sized to the budget (here,
    a slot per (scene, source) key), trains one cycle on the RIR sub-bank."""
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, rir_length=400)
    cfg = get_config(EXP, _train_opts(2) + opts, str(tmp_path), "train")
    trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
    trainer.train()
    sub = trainer._sub_bank
    assert trainer._rir_mode == "sub" and len(trainer.cycle_log) == 1
    keys = {(e.scene_id, s) for e in bundle.episodes.episodes for s in e.source_nodes}
    assert sub.capacity == (rows or len(keys))
    assert trainer.sub_bank_log[0]["rows_uploaded"] == sub.rows_uploaded > 0
    pol, sep = trainer.loss_log[0]
    assert np.isfinite(pol).all() and np.isfinite(sep).all()


@pytest.mark.parametrize("opts", [
    ["TPU.COMPUTE_DTYPE", "float32"],
    ["TPU.MESH_SHAPE", "[1]"],
    ["TPU.FUSED_CYCLE", "False"],
    ["TPU.COLLECT_UNROLL", "1"],
    ["TPU.SUB_BANK_ROWS", "0"],
    ["TPU.SUB_PREFETCH", "True"],
], ids=lambda o: o[0].split(".")[1])
def test_the_knobs_at_the_jax_packages_defaults_are_accepted(tmp_path, opts):
    """A config that sets a knob to the JAX package's default asks for what
    the port runs, so it is not refused."""
    cfg = get_config(EXP, _train_opts(4) + opts, str(tmp_path), "train")
    refuse_unported_knobs(cfg.TPU)
    refuse_unported_knobs(cfg.TPU, training=False)


@pytest.mark.parametrize("opts", KNOBS_REFUSED_BY_EVAL)
def test_eval_refuses_the_knobs_not_ported(tmp_path, opts):
    ckpt = str(tmp_path / "ckpt.0.pth")
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    save_checkpoint(ckpt, {"state_dict": policy.state_dict(), "config": {}})
    cfg = get_config("configs/test/nearTarget.yaml",
                     ["RL.PPO.hidden_size", str(HID), "EVAL_EPISODE_COUNT", "2",
                      "TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_RIR_LENGTH", "400", *opts],
                     str(tmp_path), "eval")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item|one rank per"):
        PPOTrainer(cfg, device="cpu")._eval_checkpoint(ckpt)
    assert not os.path.exists(tmp_path / "test_nearTarget_stats_ckpt_0_0.json")


@pytest.mark.parametrize("opts", [*KNOBS_PORTED, ["TPU.REPORT_MFU", "True"]],
                         ids=lambda o: o[0].split(".")[1])
def test_train_accepts_the_knobs_ported(tmp_path, opts):
    """Each dtype knob at bfloat16, and REPORT_MFU, trains one cycle (the
    sub-bank dtype on the sub route) with finite losses."""
    sub = ["TPU.RIR_MODE", "sub"] if opts[0] == "TPU.SUB_BANK_DTYPE" else []
    cfg = get_config(EXP, _train_opts(2) + opts + sub, str(tmp_path), "train")
    trainer = PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                       rir_length=400), device="cpu")
    trainer.train()
    pol, sep = trainer.loss_log[0]
    assert np.isfinite(pol).all() and np.isfinite(sep).all()
    if opts[0] == "TPU.SUB_BANK_DTYPE":
        assert trainer._sub_bank.dtype == torch.bfloat16
    assert (trainer.mfu_info is not None) == (opts[0] == "TPU.REPORT_MFU")
    shutil.rmtree(cfg.CHECKPOINT_FOLDER)


@pytest.mark.parametrize("key", [o[0] for o in KNOBS_PORTED], ids=lambda k: k.split(".")[1])
def test_a_dtype_knob_of_a_value_no_route_takes_raises(tmp_path, key):
    """float16 (or any other value) is no dtype the port runs: ValueError in
    training and evaluation, before anything runs, where the knob would
    otherwise run in float32 without a word."""
    opts = [key, "float16"]
    cfg = get_config(EXP, _train_opts(4) + opts, str(tmp_path), "train")
    with pytest.raises(ValueError, match="float16"):
        refuse_unported_knobs(cfg.TPU)
    with pytest.raises(ValueError, match="float16"):
        refuse_unported_knobs(cfg.TPU, training=False)
    with pytest.raises(ValueError, match="float16"):
        PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                 rir_length=400), device="cpu").train()
    assert not os.path.exists(cfg.CHECKPOINT_FOLDER)


@pytest.mark.parametrize("opts", KNOBS_PORTED, ids=lambda o: o[0].split(".")[1])
def test_eval_accepts_the_dtype_knobs(tmp_path, opts):
    """The dtype knobs at bfloat16 evaluate (the device evaluator here, in
    float32 whatever they say, as the JAX package's)."""
    ckpt = str(tmp_path / "ckpt.0.pth")
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    save_checkpoint(ckpt, {"state_dict": policy.state_dict(), "config": {}})
    cfg = get_config("configs/test/nearTarget.yaml",
                     ["RL.PPO.hidden_size", str(HID), "EVAL_EPISODE_COUNT", "2",
                      "TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_RIR_LENGTH", "400", *opts],
                     str(tmp_path), "eval")
    agg = PPOTrainer(cfg, device="cpu")._eval_checkpoint(ckpt)
    assert np.isfinite(agg["mono_l2_last"]["mean"])
    shutil.rmtree(tmp_path)  # the checkpoint


def test_load_pretrained_passive_separators_copies_only_the_passive_subtrees():
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    torch.manual_seed(1)
    donor = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True).state_dict()
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    tppo.load_pretrained_passive_separators(policy, donor)
    for k, v in policy.state_dict().items():
        passive = k.split(".")[0] in tppo.PASSIVE_KEYS
        assert torch.equal(v, donor[k] if passive else before[k]), k
    bad = dict(donor, **{"binSep_enc.cnn.0.0.weight": torch.zeros(1)})
    with pytest.raises(ValueError):
        tppo.load_pretrained_passive_separators(policy, bad)


@pytest.mark.parametrize("case", ["empty", "reference_prefixed", "missing_one_unet"])
def test_load_pretrained_passive_separators_refuses_an_incomplete_dict(case):
    """A dict without every passive tensor raises and copies nothing: {},
    a reference checkpoint's state dict (keys ``actor_critic.…``; the
    message names the import script) and one missing a U-Net."""
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    torch.manual_seed(1)
    donor = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True).state_dict()
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    if case == "empty":
        given, error, match = {}, KeyError, "lack 124 of their 124"
    elif case == "reference_prefixed":
        given = {"actor_critic." + k: v for k, v in donor.items()}
        error, match = ValueError, "scripts/torch_import_ref_ckpt.py"
    else:
        given = {k: v for k, v in donor.items() if not k.startswith("bin2mono_dec.")}
        error, match = KeyError, "bin2mono_dec.cnn.0.0.weight"
    with pytest.raises(error, match=match):
        tppo.load_pretrained_passive_separators(policy, given)
    for k, v in policy.state_dict().items():
        assert torch.equal(v, before[k]), k

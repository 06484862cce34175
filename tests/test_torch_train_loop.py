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
tests/test_torch_eval.py (atol 1e-4 of the largest |value|). The collect
comparison runs in test_torch_train_collect.py, the routes and knobs in
test_torch_train_knobs.py and chip_smoke.py's train phases in
test_torch_train_smoke.py, each importing this module's helpers."""

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
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

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


# The JAX package's TPU knobs the port does not honour: each is refused
# (a mesh above one device, by the port's one rank per device), never run
# as if unset. FUSED_CYCLE, PAIRWISE_FUSION and COLLECT_UNROLL are ported
# with the JAX package's routing (tests/test_torch_fusion_*.py).
    shutil.rmtree(tmp_path)  # the checkpoints, 0.2-0.4 GB each


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

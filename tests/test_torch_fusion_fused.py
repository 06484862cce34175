"""The port's TPU.FUSED_CYCLE training against the JAX package's fused cycle
(``move2hear_tpu/rl/device_rollout.py:make_train_cycle``) on the CPU, in
float64 on both sides: Adam divides by sqrt(v) + 1e-5, so float32 runs part
where a gradient entry nears 1e-5 (ROADMAP Queue 3, Adam conditioning), and
the update tests of tests/test_torch_train.py compare against float64 JAX.

The port's trainer runs one cycle of 2 x (collect + policy update) and the
refit at hidden 32, 2 envs and 3 steps on the 3x3 micro-scene, from flax's
initial weights, as a float64 copy of its policy (its weights, Adam state
and refit slabs float64, the render float32), recording what each collect
handed over. The JAX package's program then runs the same cycle under
jax.enable_x64 from the same weights: its collect replays the port's
collects in order (a carried counter picks them), its policy updates and
refit are its own, its decay the fused cycle's float32 formula on the
device. Tolerance as tests/test_torch_train.py's: the losses within 1e-4
relative (over 1e-2 for a loss below it), every parameter within 1e-4 of
|p| + lr. tests/
test_torch_fusion_pairwise.py does the same for TPU.PAIRWISE_FUSION."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import move2hear_tpu_torch.models.audio_cnn as audio_cnn
import move2hear_tpu_torch.models.unet as unet
import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.utils.params import from_jax
from move2hear_tpu_torch.utils.tb import TensorboardWriter
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/train/nearTarget.yaml"
HID, N, T, CYCLE, A = 32, 2, 3, 2, 3
REL = 1e-4
OPTS = ["NUM_PROCESSES", str(N), "NUM_UPDATES", str(CYCLE), "CHECKPOINT_INTERVAL", "1000",
        "LOG_INTERVAL", "1000", "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", str(T),
        "RL.PPO.num_updates_per_cycle", str(CYCLE), "RL.PPO.ppo_epoch", "2",
        "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
        "RL.PPO.use_linear_lr_decay", "True", "RL.PPO.use_linear_clip_decay", "True",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.MAX_RIR_LENGTH", "400",
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2"]


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """The first large torch transcendental in a process with JAX loaded
    can return one thread's chunk off (ROADMAP Queue 3): one call each."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


def _f64(tree):
    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f" else a)
    return jax.tree.map(cast, tree)


def jax_weights(seed=0):
    """(JAX policy, flax params, batch stats) of the nearTarget policy at
    hidden HID (EXTRA_DEPTH: the visual encoder reads rgb alone)."""
    policy = JPolicy(num_actions=A, hidden_size=HID, extra_depth=True, use_ddppo=True)
    obs = {"rgb": jnp.zeros((1, 128, 128, 3), jnp.uint8),
           "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
           "target_class": jnp.zeros((1, 1), jnp.int32)}
    v = jax.jit(policy.init)(jax.random.PRNGKey(seed), obs, jnp.zeros((1, HID)), jnp.ones((1, 1)))
    return (policy, jax.tree.map(np.asarray, v["params"]),
            jax.tree.map(np.asarray, v.get("batch_stats", {})))


def port_float64_run(tmp_path, knob, params, stats):
    """The port's trainer under TPU.`knob` in float64 (as the DDPPO rank
    launcher's M2H_TEST_FLOAT64) from the flax weights; returns (trainer,
    [each collect's rollouts_pol, sep_slab and stats as numpy])."""
    weights = from_jax(params, stats)
    collects = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "TensorboardWriter", lambda *a, **k: TensorboardWriter(""))
        mp.setenv("INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
        tpu_dtype, new_policy = ttrainer.tpu_dtype, ttrainer.PPOTrainer._new_policy
        mp.setattr(ttrainer, "tpu_dtype", lambda tpu, key: (
            torch.float64 if key in ("COMPUTE_DTYPE", "SEP_SLAB_DTYPE") else tpu_dtype(tpu, key)))

        def float64_policy(self):
            policy = new_policy(self)
            policy.load_state_dict(weights)
            return policy.double()

        mp.setattr(ttrainer.PPOTrainer, "_new_policy", float64_policy)
        kernel = audio_cnn.masked_mix_slice16
        for mod in (audio_cnn, unet):
            mp.setattr(mod, "masked_mix_slice16", lambda mix, mask: kernel(mix, mask.to(mix.dtype)))
        make_collect = ttrainer.make_collect

        def recording(*args, **kwargs):
            collect = make_collect(*args, **kwargs)

            def run(*a):
                out = collect(*a)
                collects.append(jax.tree.map(lambda t: t.numpy(), {
                    "rollouts_pol": out.rollouts_pol, "sep_slab": out.sep_slab,
                    "stats": out.stats}))
                return out
            return run

        mp.setattr(ttrainer, "make_collect", recording)
        cfg = get_config(EXP, [*OPTS, f"TPU.{knob}", "True"], str(tmp_path / "port"), "train")
        trainer = ttrainer.PPOTrainer(cfg, bundle=build_micro_scene(
            rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400), device="cpu")
        trainer.train()
    assert trainer._pose_obs is False and len(collects) == CYCLE
    assert trainer.final_policy.critic.fc.weight.dtype == torch.float64
    shutil.rmtree(tmp_path / "port")
    return trainer, collects


def replaying_collect(collects):
    """A JAX collect that hands over the port's collects in order: the env
    state it carries is the count of collects so far."""
    stacked = _f64(jax.tree.map(lambda *xs: np.stack(xs), *collects))

    def collect(dev, params, batch_stats, i, hidden, masks, prev_mem, rng):
        pick = jax.tree.map(lambda a: a[i], stacked)
        return jdr.CollectOutput(env_state=i + 1, hidden=hidden, masks=masks,
                                 prev_mem_masked=prev_mem, rollouts_pol=pick["rollouts_pol"],
                                 sep_slab=pick["sep_slab"], stats=pick["stats"])
    return collect


def carry0():
    return (jnp.int32(0), jnp.zeros((N, HID)), jnp.ones((N, 1)), jnp.zeros((N, 512, 32, 1)))


def assert_matches(trainer, losses, j_params, params, stats):
    """The port's losses and parameters against the JAX float64 run's."""
    (pol, sep), = trainer.loss_log
    for ours, ref in ((pol, losses[0]), (sep, losses[1])):
        # relative, but over 1e-2 for a loss below it: an epoch's action
        # loss starts at the mean of normalised advantages, 0 but for
        # rounding (chip_smoke.py's ddppo-parity reads losses so)
        assert (np.abs(ours - ref) <= REL * np.maximum(np.abs(ref), 1e-2)).all(), (ours, ref)
    ref = from_jax(jax.tree.map(np.asarray, j_params), stats)
    start = from_jax(params, stats)
    ours = trainer.final_policy.state_dict()
    cfg = tppo.PPOConfig()
    moved = 0
    for k, v in ref.items():
        if not v.is_floating_point() or "running_" in k:
            continue
        lr = cfg.lr_sep if k.startswith("acoustic_mem.") else cfg.lr_pol
        err = float(((ours[k] - v.double()).abs() / (v.double().abs() + lr)).max())
        assert err <= REL, (k, err)
        moved += not torch.equal(v, start[k])
    assert moved > 10


def test_fused_cycle_matches_the_jax_fused_program(tmp_path, monkeypatch):
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    j_policy, params, stats = jax_weights()
    trainer, collects = port_float64_run(tmp_path, "FUSED_CYCLE", params, stats)
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        jcfg = jppo.PPOConfig(ppo_epoch=2, num_mini_batch=1)
        state = jppo.create_agent_state(jcfg, {"params": _f64(params), "batch_stats": _f64(stats)})
        cycle = jdr.make_train_cycle(
            j_policy, jcfg, replaying_collect(collects),
            jppo.make_update_pol(j_policy, jcfg, N, pose_bank=False),
            jdr.make_update_sep_from_slabs(j_policy, jcfg, N, CYCLE),
            CYCLE, T, CYCLE, True, True)
        out = jax.jit(cycle)(None, state, *carry0(), jax.random.PRNGKey(0), jnp.int32(0))
        state, pol, sep = out[0], np.asarray(out[5]), np.asarray(out[6])
        assert int(out[1]) == CYCLE
    assert_matches(trainer, (pol, sep), state.params, params, stats)

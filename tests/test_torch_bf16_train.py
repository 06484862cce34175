"""The port's device-path training in bfloat16 (``TPU.COMPUTE_DTYPE``,
``SEP_SLAB_DTYPE`` and ``SEP_REFIT_DTYPE`` bfloat16, ``REPORT_MFU`` on)
against the JAX package's trainer under the same config on the CPU: one
cycle of 2 x (collect + policy update) and the refit at hidden 32, 2 envs,
3 steps. The JAX trainer runs first (one device, its programs compiled
without XLA's excess precision, as tests/test_torch_bf16_models.py says
why); the port's trainer then runs from the same initial weights,
replaying the actions JAX sampled.

Tolerances: the losses within LOSS_REL relative (or LOSS_ABS absolute
below 1): two bfloat16 implementations that sum in different orders part
by about a bfloat16 ulp (2**-8 relative) in each separator output, and the
losses average such outputs. The refit's bfloat16 slabs under the
discriminator of tests/test_torch_bf16_models.py where storage is what
rounds (the render's float32 target, the collect's values standing for a
float32 slab), and within a bfloat16 ulp where the values are bfloat16
already (the separators' and the memory's outputs).

REPORT_MFU: ``mfu_info`` has the JAX package's keys, and its
``flops_per_env_step`` equals a count written here from the layer shapes
within 1e-9 relative. The JAX probe's figure for the same config is
printed beside it, not asserted: XLA's cost_analysis also counts the
elementwise operations and the render's DFT matmuls."""

import math
import shutil

import jax
import numpy as np
import pytest
import torch

import move2hear_tpu.rl.device_rollout as jdr
import move2hear_tpu.rl.trainer as jtrainer
import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.utils.params import from_jax
from test_torch_bf16_models import discriminate
from _torch_quick import skip_setup_costs
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, CYCLE, EPOCHS = 32, 2, 3, 2, 1
LOSS_REL, LOSS_ABS = 1e-3, 1e-5
OPTS = ["NUM_PROCESSES", str(N), "NUM_UPDATES", str(CYCLE), "CHECKPOINT_INTERVAL", "1000",
        "LOG_INTERVAL", "1000", "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", str(T),
        "RL.PPO.num_updates_per_cycle", str(CYCLE), "RL.PPO.ppo_epoch", str(EPOCHS),
        "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
        "RL.PPO.sep_reward_weight", "1.0", "RL.PPO.nav_reward_weight", "0.0",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", "TENSORBOARD_DIR", "tb",
        "TPU.MESH_SHAPE", "[1]", "TPU.COMPUTE_DTYPE", "bfloat16",
        "TPU.SEP_SLAB_DTYPE", "bfloat16", "TPU.SEP_REFIT_DTYPE", "bfloat16",
        "TPU.REPORT_MFU", "True"]
MFU_KEYS = {"flops_per_rollout_collect", "flops_per_update_pol", "flops_per_cycle_sep_refit",
            "flops_per_cycle_total", "env_steps_per_cycle", "flops_per_env_step", "method"}


def _bundle(pkg_build):
    return pkg_build(rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX trainer, port trainer, JAX's refit buffer, the port's, the
    float32 slab values the port's collects handed over, initial weights)."""
    tmp = tmp_path_factory.mktemp("bf16_train")
    captured, actions, j_bufs = {}, [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpk, "_PALLAS_STATUS", {})
        mp.setenv("INTERRUPTED_STATE_DIR", str(tmp / "interrupted"))
        skip_setup_costs(mp)
        create = jtrainer.create_agent_state

        def capture_init(cfg, variables):
            captured["variables"] = jax.tree.map(np.asarray, variables)
            return create(cfg, variables)

        make_collect, make_sep, jit = jdr.make_collect, jdr.make_update_sep_from_slabs, jax.jit

        def marked(make, mark):
            def build(*args, **kwargs):
                fn = make(*args, **kwargs)

                def run(*a, **k):
                    return fn(*a, **k)

                setattr(run, mark, True)
                return run
            return build

        def recording_jit(fn, *args, **kwargs):
            compiled = jit(fn, *args, **kwargs,
                           compiler_options={"xla_allow_excess_precision": False})
            if getattr(fn, "record_actions", False):
                def run(*a):
                    out = compiled(*a)
                    actions.append(np.asarray(out.rollouts_pol["actions"]))
                    return out
                run.lower = compiled.lower  # the MFU probe lowers its collects
                return run
            if getattr(fn, "record_buffer", False):
                def run(state, buf, *a):
                    j_bufs.append({f: np.asarray(getattr(buf, f), np.float32)
                                   for f in ("pred_mono", "gt_mono", "prev_mem")})
                    j_bufs[-1]["dtype"] = buf.pred_mono.dtype
                    return compiled(state, buf, *a)
                run.lower = compiled.lower
                return run
            return compiled

        mp.setattr(jtrainer, "create_agent_state", capture_init)
        mp.setattr(jdr, "make_collect", marked(make_collect, "record_actions"))
        mp.setattr(jdr, "make_update_sep_from_slabs", marked(make_sep, "record_buffer"))
        mp.setattr(jax, "jit", recording_jit)
        with jax.default_matmul_precision("highest"):
            j = jtrainer.PPOTrainer(j_get_config(model_dir=str(tmp / "jax"), opts=OPTS),
                                    bundle=_bundle(j_build_micro_scene))
            j.train()

    v = captured["variables"]
    weights = from_jax(v["params"], v.get("batch_stats", {}))
    replay = iter(actions)
    t_bufs, handed = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INTERRUPTED_STATE_DIR", str(tmp / "interrupted"))
        skip_setup_costs(mp)
        new_policy, t_make_collect = ttrainer.PPOTrainer._new_policy, ttrainer.make_collect
        t_make_sep = ttrainer.make_update_sep_from_slabs

        def jax_weights(self):
            policy = new_policy(self)
            policy.load_state_dict(weights)
            return policy

        def replaying_collect(*args, **kwargs):
            def run(*a):
                acts = torch.from_numpy(next(replay)).long()
                out = t_make_collect(*args, **kwargs, sampler=lambda d, t: acts[t])(*a)
                handed.append({"gt_mono": out.sep_slab["gt_mono"].clone()})
                return out
            return run

        def recording_sep(*args, **kwargs):
            update = t_make_sep(*args, **kwargs)

            def run(state, buf, *a, **k):
                t_bufs.append({f: getattr(buf, f).clone() for f in ("pred_mono", "gt_mono",
                                                                    "prev_mem")})
                return update(state, buf, *a, **k)
            return run

        mp.setattr(ttrainer.PPOTrainer, "_new_policy", jax_weights)
        mp.setattr(ttrainer, "make_collect", replaying_collect)
        mp.setattr(ttrainer, "make_update_sep_from_slabs", recording_sep)
        ours = ttrainer.PPOTrainer(get_config(None, OPTS, str(tmp / "port"), "train"),
                                   bundle=_bundle(build_micro_scene), device="cpu")
        ours.train()
    assert next(replay, None) is None and len(j_bufs) == len(t_bufs) == 1
    yield j, ours, j_bufs[0], t_bufs[0], handed
    shutil.rmtree(tmp)


def test_bf16_cycle_losses_and_slabs_match_the_jax_trainer(runs):
    j, ours, j_buf, t_buf, handed = runs
    assert ours.final_policy.dtype == torch.bfloat16
    assert len(ours.loss_log) == len(j._loss_log) == 1
    for (pol, sep), (jpol, jsep) in zip(ours.loss_log, j._loss_log):
        print("pol", pol.tolist(), jpol.tolist(), "sep", sep.tolist(), jsep.tolist())
        np.testing.assert_allclose(pol, jpol, rtol=LOSS_REL, atol=LOSS_ABS)
        np.testing.assert_allclose(sep, jsep, rtol=LOSS_REL, atol=LOSS_ABS)
    assert j_buf["dtype"] == jax.numpy.bfloat16
    for k in ("pred_mono", "gt_mono", "prev_mem"):
        assert t_buf[k].dtype == torch.bfloat16, k
    # the bf16 separators' and memory's outputs are bf16 already (the memory
    # times a 0/1 mask): storage rounds them no further, and the two
    # packages' bf16 convolutions part by an ulp here and there
    for k in ("pred_mono", "prev_mem"):
        np.testing.assert_allclose(t_buf[k].float().numpy(), j_buf[k], atol=2.0**-5, err_msg=k)
        assert np.abs(t_buf[k].float().numpy() - j_buf[k]).mean() < 1e-4, k
    # the render's float32 target is rounded by the storage alone
    discriminate(t_buf["gt_mono"], j_buf["gt_mono"], torch.cat([h["gt_mono"] for h in handed]),
                 "gt_mono slab")


def _conv(b, cin, cout, k, oh, ow, grad_in=False, grad_w=False):
    """FLOPs FlopCounterMode counts for a convolution (or a transposed one,
    given its input's spatial size as oh, ow) and its backward."""
    f = 2 * b * cin * cout * k * k * oh * ow
    return f * (1 + grad_in + grad_w)


def _linear(m, k, n, grad_in=False, grad_w=False):
    return 2 * m * k * n * (1 + grad_in + grad_w)


def _unet(b, bin2mono):
    """Encoder and decoder of one U-Net at batch b, forward only."""
    cin = 32 if bin2mono else 33
    f, side = 0, 32
    for cout in (64, 128, 256, 512, 512):
        side //= 2
        f += _conv(b, cin, cout, 4, side, side)
        cin = cout
    n_out = 16 if bin2mono else 32
    side = 1
    for cin, cout in zip((512, 1024, 512, 256, 128), (512, 256, 128, 64, n_out)):
        f += _conv(b, cin, cout, 4, side, side)  # transposed: the input's size
        side *= 2
    return f + _conv(b, n_out, n_out, 1, 32, 32)


def _audio_cnn(b, grad=False):
    """The policy's AudioCNN: 32x32 -> 7 -> 2 -> 1, then the dense layer;
    in the update the first conv's input needs no gradient."""
    return (_conv(b, 32, 32, 8, 7, 7, grad_w=grad) + _conv(b, 32, 64, 4, 2, 2, grad, grad)
            + _conv(b, 64, 32, 2, 1, 1, grad, grad) + _linear(b, 32, HID, grad, grad))


def _visual_cnn(b, grad=False):
    """The policy's VisualCNN over rgb + depth frames: 128x128 -> 31 -> 14 ->
    12, then the dense layer; the frames need no gradient."""
    return (_conv(b, 4, 32, 8, 31, 31, grad_w=grad) + _conv(b, 32, 64, 4, 14, 14, grad, grad)
            + _conv(b, 64, 32, 3, 12, 12, grad, grad) + _linear(b, 32 * 12 * 12, HID, grad, grad))


def _gru(steps, b, in_dim, grad=False):
    """The bf16 GRU: the input-side GEMM over all steps, the hidden-side a
    step; in the update the input side back-propagates into the encoders
    and the hidden side through the steps (not into the initial state)."""
    f = _linear(steps * b, in_dim, 3 * HID, grad, grad)
    f += _linear(b, HID, 3 * HID, grad_w=grad) + (steps - 1) * _linear(b, HID, 3 * HID, grad, grad)
    return f


def _heads(b, grad=False):
    return _linear(b, HID, 3, grad, grad) + _linear(b, HID, 1, grad, grad)


def test_mfu_info_counts_the_layers_of_the_cycle(runs):
    j, ours, *_ = runs
    info = ours.mfu_info
    assert set(info) == MFU_KEYS
    # rgb and depth frames; the 36 poses of the 3x3 scene outnumber the N * T
    # steps, so the collect and the update run the visual encoder a step
    assert ours.final_policy.pol_net.visual_encoder.cnn[0].in_channels == 4
    in_dim = 3 * HID
    step = (_unet(N, False) + _unet(N, True) + _conv(N, 32, 32, 3, 32, 32)
            + _conv(N, 32, 16, 3, 32, 32) + _visual_cnn(N) + 2 * _audio_cnn(N)
            + _gru(1, N, in_dim) + _heads(N))
    # a collect: T steps and the bootstrap forward (its value head only)
    collect = (T + 1) * step - _linear(N, HID, 3)
    update = EPOCHS * (_visual_cnn(T * N, grad=True) + 2 * _audio_cnn(T * N, grad=True)
                       + _gru(T, N, in_dim, grad=True) + _heads(T * N, grad=True))
    refit = CYCLE * EPOCHS * (_conv(T * CYCLE * N, 32, 32, 3, 32, 32, grad_w=True)
                              + _conv(T * CYCLE * N, 32, 16, 3, 32, 32, True, True))
    total = CYCLE * (collect + update) + refit
    print(f"port {info['flops_per_env_step']:.6e} FLOPs/env-step (collect "
          f"{info['flops_per_rollout_collect']:.6e}, update {info['flops_per_update_pol']:.6e}, "
          f"refit {info['flops_per_cycle_sep_refit']:.6e}); analytic {total / (CYCLE * T * N):.6e}; "
          f"JAX probe {j.mfu_info and j.mfu_info['flops_per_env_step']}")
    assert info["env_steps_per_cycle"] == CYCLE * T * N
    assert math.isclose(info["flops_per_rollout_collect"], collect, rel_tol=1e-9)
    assert math.isclose(info["flops_per_update_pol"], update, rel_tol=1e-9)
    assert math.isclose(info["flops_per_cycle_sep_refit"], refit, rel_tol=1e-9)
    assert math.isclose(info["flops_per_env_step"], total / (CYCLE * T * N), rel_tol=1e-9)

"""The port's host paths in bfloat16 (``TPU.COMPUTE_DTYPE`` bfloat16)
against the JAX package's on the CPU, their XLA programs compiled without
excess precision (tests/test_torch_bf16_models.py says why):

- the host training loop (host envs in process, one device step a step,
  the refit rendering anew): one cycle of 2 x (3 steps + policy update)
  and the refits at hidden 32, 2 envs, the port replaying the actions the
  JAX loop's envs took; the losses within LOSS_REL relative (or LOSS_ABS
  absolute). The second update's action loss is a mean of (ratio - 1) x
  advantage terms near 1e-4, and its log-probabilities come from logits
  of about 1e-2 that the bfloat16 head rounds at 2**-8 relative: it parts
  by a few 1e-5 (tests/test_torch_bf16_train.py's device cycle stays
  within 1e-5);
- the host evaluator, deterministic actions, 2 near-target episodes: equal
  actions, and its per-step STFT-L2s under the discriminator of
  tests/test_torch_bf16_models.py, JAX's float32 evaluation the yardstick
  (in test_torch_bf16_host_eval.py).
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import move2hear_tpu.rl.trainer as jtrainer
import move2hear_tpu_torch.models.distributions as tdist
import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env import environment as j_environment
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.utils.params import from_jax
from _torch_quick import skip_setup_costs
from _torch_threads import cap_torch_threads

cap_torch_threads()

N, T, CYCLE = 2, 3, 2
LOSS_REL, LOSS_ABS = 1e-3, 1e-4
OPTS = ["NUM_PROCESSES", str(N), "NUM_UPDATES", str(CYCLE), "CHECKPOINT_INTERVAL", "1000",
        "LOG_INTERVAL", "1000", "RL.PPO.hidden_size", "32", "RL.PPO.num_steps", str(T),
        "RL.PPO.num_updates_per_cycle", str(CYCLE), "RL.PPO.ppo_epoch", "1",
        "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
        "RL.PPO.use_linear_lr_decay", "False", "RL.PPO.use_linear_clip_decay", "False",
        "RL.PPO.sep_reward_weight", "1.0", "RL.PPO.nav_reward_weight", "0.0",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.MAX_RIR_LENGTH", "400",
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", "TENSORBOARD_DIR", "tb",
        "TPU.MESH_SHAPE", "[1]", "TPU.DEVICE_ENV", "False", "USE_SYNC_VECENV", "True",
        "TPU.COMPUTE_DTYPE", "bfloat16"]


def _no_excess_precision(mp):
    jit = jax.jit

    def jit_without_excess(fn=None, **kwargs):
        opts = {"compiler_options": {"xla_allow_excess_precision": False}, **kwargs}
        return jit(fn, **opts) if fn is not None else (lambda f: jit(f, **opts))

    mp.setattr(jax, "jit", jit_without_excess)
    return jit


def test_bf16_host_loop_matches_the_jax_host_loop(tmp_path):
    captured, actions, losses = {}, [], {"pol": [], "sep": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpk, "_PALLAS_STATUS", {})
        mp.setenv("INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
        skip_setup_costs(mp)
        create, j_step = jtrainer.create_agent_state, j_environment.AAViSSEnv.step

        def capture_init(cfg, variables):
            captured["variables"] = jax.tree.map(np.asarray, variables)
            return create(cfg, variables)

        def record(env, action):
            actions.append(int(action))
            return j_step(env, action)

        jit = jax.jit
        mp.setattr(jtrainer, "create_agent_state", capture_init)
        mp.setattr(j_environment.AAViSSEnv, "step", record)
        mp.setattr(jax, "jit", lambda fn=None, **kw: _recording_jit(jit, fn, losses, **kw))
        with jax.default_matmul_precision("highest"):
            j = jtrainer.PPOTrainer(j_get_config(model_dir=str(tmp_path / "jax"), opts=OPTS),
                                    bundle=j_build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                               near_target=True, rir_length=400))
            j.train()
    assert len(actions) == CYCLE * T * N and len(losses["pol"]) == len(losses["sep"]) == CYCLE

    v = captured["variables"]
    weights = from_jax(v["params"], v.get("batch_stats", {}))
    replay = torch.tensor(actions).reshape(CYCLE * T, N, 1)
    draws = iter(range(10**6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
        skip_setup_costs(mp)
        new_policy = ttrainer.PPOTrainer._new_policy

        def jax_weights(self):
            policy = new_policy(self)
            policy.load_state_dict(weights)
            return policy

        def replayed(dist, generator=None, rows=None):
            i = next(draws)  # the first forward's draw is the first step's action
            return replay[i] if i < len(replay) else torch.zeros((N, 1), dtype=torch.long)

        mp.setattr(ttrainer.PPOTrainer, "_new_policy", jax_weights)
        mp.setattr(tdist.Categorical, "sample", replayed)
        ours = ttrainer.PPOTrainer(get_config(None, OPTS, str(tmp_path / "port"), "train"),
                                   bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                            near_target=True, rir_length=400),
                                   device="cpu")
        ours.train()
    assert ours._rir_mode == "host" and ours.final_policy.dtype == torch.bfloat16
    (pol, sep), = ours.loss_log
    j_pol = np.array([[float(x) for x in out] for out in losses["pol"]])
    j_sep = np.array([[float(x) for x in out] for out in losses["sep"]])
    print("pol", pol.tolist(), j_pol.tolist(), "sep", sep.tolist(), j_sep.tolist())
    np.testing.assert_allclose(pol, j_pol, rtol=LOSS_REL, atol=LOSS_ABS)
    np.testing.assert_allclose(sep, j_sep, rtol=LOSS_REL, atol=LOSS_ABS)
    shutil.rmtree(tmp_path)  # both packages' checkpoints


def _recording_jit(jit, fn, losses, **kwargs):
    """jax.jit without excess precision; the JAX host loop's two updates
    (the functions make_update_pol and make_update_sep build) also record
    their losses."""
    opts = {"compiler_options": {"xla_allow_excess_precision": False}, **kwargs}
    if fn is None:
        return lambda f: _recording_jit(jit, f, losses, **kwargs)
    compiled = jit(fn, **opts)
    name = getattr(fn, "__qualname__", "")
    key = "pol" if "make_update_pol" in name else "sep" if "make_update_sep" in name else None
    if key is None:
        return compiled

    def run(*a, **k):
        state, out = compiled(*a, **k)
        losses[key].append(out)
        return state, out
    return run

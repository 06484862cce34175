"""DDPPO's preemptive rollout sync in the JAX package's mocked world
(tests/test_preemptive_sync.py:229-284): rank 0 of 4 by the environment,
one process, a num-done store that always reads the world done, so every
rollout stops after its prefix of ceil(threshold * T) steps. The JAX
trainer runs first (one device); the port's trainer then runs under the
same store from the same initial weights, replaying the actions JAX
sampled. The refit buffers fill cycle * ceil(threshold * T) rows on both,
the losses agree within 1e-3 relative, and each tensor's parameter change
within 3e-4 in norm (chip_smoke.py's TRAIN_DP_TOL: the float32 updates of
the two packages part where Adam's eps conditioning shows). The JAX
trainer's compiles take about a minute on the CPU."""

import math
import shutil

import jax
import numpy as np
import torch

import move2hear_tpu.rl.device_rollout as jdr
import move2hear_tpu.rl.trainer as jtrainer
import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.parallel.ddppo import RolloutSyncState as JRolloutSyncState
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.parallel.ddppo import RolloutSyncState
from move2hear_tpu_torch.utils.params import from_jax
from _torch_quick import skip_setup_costs
from _torch_threads import cap_torch_threads

cap_torch_threads()

T, CYCLE, THRESHOLD = 4, 2, 0.5
S0 = math.ceil(THRESHOLD * T)


class _AlwaysStopStore:
    def add(self, generation):
        return 10**6

    def get(self, generation):
        return 10**6

    def close(self):
        pass


OPTS = ["NUM_PROCESSES", "2", "NUM_UPDATES", str(2 * CYCLE), "CHECKPOINT_INTERVAL", "1000",
        "LOG_INTERVAL", "1000", "RL.PPO.hidden_size", "32", "RL.PPO.num_steps", str(T),
        "RL.PPO.num_updates_per_cycle", str(CYCLE), "RL.PPO.ppo_epoch", "1",
        "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
        "RL.PPO.short_rollout_threshold", str(THRESHOLD), "RL.PPO.sync_frac", "0.5",
        "RL.PPO.sep_reward_weight", "1.0", "RL.PPO.nav_reward_weight", "0.0",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", "TENSORBOARD_DIR", "tb",
        "TPU.MESH_SHAPE", "[1]"]


def test_mocked_world_truncation_matches_the_jax_trainer(tmp_path, monkeypatch):
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    monkeypatch.setenv("INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
    skip_setup_costs(monkeypatch)
    # the JAX run: its initial variables and the actions of every collect
    captured, actions = {}, []
    create = jtrainer.create_agent_state

    def capture_init(cfg, variables):
        captured["variables"] = jax.tree.map(np.asarray, variables)
        return create(cfg, variables)

    make_collect, jit = jdr.make_collect, jax.jit

    def marked_collect(*args, **kwargs):
        collect = make_collect(*args, **kwargs)

        def run(*a):
            return collect(*a)

        run.record_actions = True
        return run

    def recording_jit(fn, *args, **kwargs):
        compiled = jit(fn, *args, **kwargs)
        if not getattr(fn, "record_actions", False):
            return compiled

        def run(*a):
            out = compiled(*a)
            actions.append(np.asarray(out.rollouts_pol["actions"]))
            return out

        return run

    monkeypatch.setattr(jtrainer, "create_agent_state", capture_init)
    monkeypatch.setattr(jdr, "make_collect", marked_collect)
    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(jtrainer, "get_distrib_info", lambda: (0, 0, 4))
    monkeypatch.setattr(jtrainer.PPOTrainer, "_make_rollout_sync", lambda self, t: JRolloutSyncState(
        sync_frac=0.5, short_rollout_threshold=THRESHOLD, num_steps=t, world_size=4,
        store=_AlwaysStopStore()))
    jcfg = j_get_config(model_dir=str(tmp_path / "jax"), opts=OPTS)
    with jax.default_matmul_precision("highest"):
        j = jtrainer.PPOTrainer(jcfg, bundle=j_build_micro_scene(
            rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400))
        j.train()
    monkeypatch.setattr(jax, "jit", jit)
    j_params = jax.tree.map(np.asarray, j._final_state.params)
    assert j._last_sep_fill == CYCLE * S0 and len(actions) == 2 * CYCLE
    assert all(a.shape[0] == S0 for a in actions)

    # the port: same weights, same store, JAX's actions replayed
    v = captured["variables"]
    weights = from_jax(v["params"], v.get("batch_stats", {}))
    new_policy = ttrainer.PPOTrainer._new_policy

    def jax_weights(self):
        policy = new_policy(self)
        policy.load_state_dict(weights)
        return policy

    replay = iter(actions)
    t_make_collect = ttrainer.make_collect

    def replaying_collect(*args, **kwargs):
        def run(*a):
            acts = torch.from_numpy(next(replay)).long()
            return t_make_collect(*args, **kwargs, sampler=lambda d, t: acts[t])(*a)

        return run

    monkeypatch.setattr(ttrainer.PPOTrainer, "_new_policy", jax_weights)
    monkeypatch.setattr(ttrainer, "make_collect", replaying_collect)
    monkeypatch.setattr(ttrainer, "get_distrib_info", lambda: (0, 0, 4))
    monkeypatch.setattr(ttrainer.PPOTrainer, "_make_rollout_sync", lambda self, t: RolloutSyncState(
        sync_frac=0.5, short_rollout_threshold=THRESHOLD, num_steps=t, world_size=4,
        store=_AlwaysStopStore()))
    cfg = get_config(None, OPTS, str(tmp_path / "port"), "train")
    ours = ttrainer.PPOTrainer(cfg, bundle=build_micro_scene(
        rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400), device="cpu")
    ours.train()
    assert ours._last_sep_fill == CYCLE * S0 and next(replay, None) is None
    for (pol, sep), (jpol, jsep) in zip(ours.loss_log, j._loss_log):
        np.testing.assert_allclose(pol, jpol, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(sep, jsep, rtol=1e-3, atol=1e-5)
    ref = from_jax(j_params, v.get("batch_stats", {}))
    worst = {}
    for k, p in ours.final_policy.state_dict().items():
        change = weights[k] - ref[k]
        if p.is_floating_point() and change.any():
            worst[k] = float(torch.linalg.vector_norm(p - ref[k])
                             / torch.linalg.vector_norm(change))
    print("worst", sorted(worst.items(), key=lambda kv: -kv[1])[:5], len(worst))
    assert max(worst.values()) <= 3e-4  # chip_smoke.py TRAIN_DP_TOL
    shutil.rmtree(tmp_path)

"""The host env path's training modules on the CPU: the rollout buffers of
``rl/rollout.py`` against the JAX package's over inserts and the roll after
an update (exact: the same copies); ``rl/ppo.py:make_update_sep``, the
separator refit that renders anew from the stored keys, against a float64
JAX step on one injected buffer (hidden 32, 2 envs, 3 steps, RIR length
400; both packages take one render of the buffer, JAX's, as
tests/test_torch_pretrain.py does, since two renders differ by f16 ulps),
both packages in float64, losses within 1e-9 relative and the change of
every parameter within 1e-6 of |change| + lr (the JAX change reaches the
port's layout through ``from_jax``, which rounds it to float32); a run of the host loop
(``TPU.RIR_MODE host``) that trains, checkpoints, resumes and writes
episode windows and TensorBoard scalars, as tests/test_trainer_host.py
checks the JAX one, and with a reward weighting the device path refuses.
The separator refit of the host path is held against the JAX package in
tests/test_torch_host_refit.py, the file-backed pretrain source in
tests/test_torch_file_backed.py and its epoch in tests/test_torch_pretrain.py."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.rl import rollout as jro
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.rl import rollout as tro
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, S, R = 32, 2, 3, 2, 400
SPEC = (16, 4)  # a small spectrogram for the buffer tests


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """In a process with JAX loaded, the first call of a torch transcendental
    over a large CPU tensor sometimes returns one intra-op thread's chunk off
    by up to 1.5e-4 relative (ROADMAP, Queue 3); one call of each first."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)


def _assert_tree_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_tree_equal(ours[k], ref[k])
        else:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_rollout_buffers_match_jax():
    """Two rollouts of T steps into both buffers (the second after the roll
    of slot T into slot 0, and one roll from a truncated `last`)."""
    rng = np.random.default_rng(0)
    shapes = {"mixed_bin_audio_mag": SPEC + (2,), "rgb": (4, 4, 3), "target_class": (1,)}
    j_pol = jro.create_rollout_pol(T, N, shapes, HID, spec_shape=SPEC)
    j_sep = jro.create_rollout_sep(2 * T, N, S, R, spec_shape=SPEC)
    pol = tro.create_rollout_pol(T, N, shapes, HID, spec_shape=SPEC)
    sep = tro.create_rollout_sep(2 * T, N, S, R, spec_shape=SPEC)
    f, tt = SPEC
    sep_step = 0
    for rollout in range(2):
        for step in range(T):
            obs = {"mixed_bin_audio_mag": rng.standard_normal((N, f, tt, 2)).astype(np.float32),
                   "rgb": rng.integers(0, 256, (N, 4, 4, 3)).astype(np.uint8),
                   "target_class": rng.integers(0, 10, (N, 1))}
            args = [rng.standard_normal((N, HID)).astype(np.float32),
                    rng.integers(0, 3, (N, 1)),
                    *[rng.standard_normal((N, 1)).astype(np.float32) for _ in range(3)],
                    (rng.uniform(0, 1, (N, 1)) > 0.3).astype(np.float32),
                    rng.standard_normal((N, f, tt, 2)).astype(np.float32),
                    *[rng.standard_normal((N, f, tt, 1)).astype(np.float32) for _ in range(2)]]
            j_pol = jro.insert_pol(j_pol, jnp.asarray(step), {k: jnp.asarray(v) for k, v in obs.items()},
                                   *map(jnp.asarray, args))
            tro.insert_pol(pol, step, {k: torch.from_numpy(v) for k, v in obs.items()},
                           *map(torch.from_numpy, args))
            keys = [rng.integers(0, 12, (N, S)), rng.standard_normal((N, S, R, 2)).astype(np.float32),
                    rng.integers(0, 10, (N, 1)), args[5], args[8]]
            j_sep = jro.insert_sep(j_sep, jnp.asarray(sep_step), *map(jnp.asarray, keys))
            tro.insert_sep(sep, sep_step, *map(torch.from_numpy, keys))
            sep_step += 1
        _assert_tree_equal(_np(pol.as_dict()), _np(j_pol.as_dict()))
        last = None if rollout == 0 else 2
        j_pol = jro.after_update_pol(j_pol, None if last is None else jnp.int32(last))
        tro.after_update_pol(pol, last)
        _assert_tree_equal(_np(pol.as_dict()), _np(j_pol.as_dict()))
    _assert_tree_equal(_np(sep.as_dict()), _np(j_sep.as_dict()))
    j_sep, _ = jro.after_update_sep(j_sep), tro.after_update_sep(sep)
    _assert_tree_equal(_np(sep.as_dict()), _np(j_sep.as_dict()))
    assert pol.actions.dtype == torch.long and pol.observations["rgb"].dtype == torch.uint8


def _host_opts(updates):
    return ["NUM_PROCESSES", str(N), "NUM_UPDATES", str(updates), "CHECKPOINT_INTERVAL", "2",
            "LOG_INTERVAL", "1", "USE_SYNC_VECENV", "True", "TPU.RIR_MODE", "host",
            "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", "2",
            "RL.PPO.num_updates_per_cycle", "2", "RL.PPO.ppo_epoch", "1",
            "RL.PPO.pretrained_passive_separators_ckpt", "", "TPU.MAX_RIR_LENGTH", str(R),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3"]


def test_host_loop_trains_checkpoints_resumes_and_logs(tmp_path):
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, near_target=True, rir_length=R)
    cfg = get_config("configs/train/nearTarget.yaml", _host_opts(4), str(tmp_path / "a"), "train")
    trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
    trainer.train()
    assert trainer._rir_mode == "host" and trainer.vector_env == "SyncVectorEnv"
    assert sorted(os.listdir(cfg.CHECKPOINT_FOLDER)) == ["ckpt.0.pth", "ckpt.1.pth", "ckpt.2.pth"]
    ckpt = load_checkpoint(os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2.pth"))
    assert ckpt["extra_state"]["update_count"] == 4
    assert {"optimizer_pol", "optimizer_sep", "config"} <= set(ckpt)
    assert all(torch.isfinite(v).all() for v in ckpt["state_dict"].values() if v.is_floating_point())
    # 8 env-steps per env in 3-step episodes: at least 2 episode ends per env
    w = trainer._windows
    assert len(w["reward"]) >= 2 * N and all(s == 3 for s in w["steps"])
    assert np.isfinite(list(w["reward"])).all() and np.isfinite(list(w["mem_l2_last"])).all()
    assert len(trainer.cycle_log) == 2 and trainer.cycle_log[0]["env_steps"] == 2 * 2 * N
    for pol, sep in trainer.loss_log:
        assert pol.shape == sep.shape == (2, 3) and np.isfinite(pol).all() and np.isfinite(sep).all()
    assert trainer.rir_bytes_per_step == N * S * R * 2 * 4
    assert any("tfevents" in f for f in os.listdir(cfg.TENSORBOARD_DIR))

    # RESUME_CKPT continues from update 4 with the saved optimizer states
    resume = os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2.pth")
    cfg2 = get_config("configs/train/nearTarget.yaml", _host_opts(6) + ["RESUME_CKPT", resume],
                      str(tmp_path / "b"), "train")
    again = PPOTrainer(cfg2, bundle=bundle, device="cpu")
    again.train()
    last = load_checkpoint(os.path.join(cfg2.CHECKPOINT_FOLDER, "ckpt.1.pth"))
    assert last["extra_state"]["update_count"] == 6 and len(again.cycle_log) == 1
    assert not torch.equal(last["state_dict"]["critic.fc.weight"], ckpt["state_dict"]["critic.fc.weight"])
    shutil.rmtree(tmp_path)  # the checkpoints take 1 GB


def test_host_loop_takes_env_rewards_for_other_weightings(tmp_path):
    """The device path refuses a weighting of the two rewards; the host path,
    as the JAX package's, trains with the env's (distance) rewards."""
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, near_target=False, rir_length=R)
    cfg = get_config("configs/train/nearTarget.yaml", _host_opts(2) + [
        "RL.PPO.sep_reward_weight", "0.5", "RL.PPO.nav_reward_weight", "0.5",
        "RL.PPO.num_steps", "6"],
        str(tmp_path), "train")
    trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
    trainer.train()
    assert trainer._rir_mode == "host" and trainer.cycle_log[0]["reward_abs_mean"] > 0
    shutil.rmtree(tmp_path)  # the checkpoints take 0.4 GB


def test_file_backed_bundle_feeds_the_dense_and_sub_device_paths(tmp_path):
    """A config pointing at SoundSpaces-layout files trains on the device
    path too: the dense banks read every RIR through FileAudioDB.get_rir,
    the sub-bank rows through get_rir_block, and one cycle of each gives
    the same losses (the sub-bank gathers the dense bank's values)."""
    from move2hear_tpu_torch.env.audio_db import FileAudioDB
    from move2hear_tpu_torch.env.layout import write_soundspaces_layout

    lay = write_soundspaces_layout(tmp_path / "layout", num_scenes=2, rows=3, cols=4,
                                   episodes_per_scene=2, rir_length=R)
    logs = []
    for mode in ("dense", "sub"):
        opts = [o for o in _host_opts(2) if o not in ("TPU.RIR_MODE", "host")]
        cfg = get_config("configs/train/nearTarget.yaml", opts + ["TPU.RIR_MODE", mode] + lay["opts"],
                         str(tmp_path / mode), "train")
        trainer = PPOTrainer(cfg, device="cpu")
        trainer.train()
        assert trainer._rir_mode == mode and isinstance(trainer._bundle.audio_db, FileAudioDB)
        assert sorted(trainer._bundle.scenes) == ["scene00", "scene01"]
        logs.append(trainer.loss_log[0])
    for dense, sub in zip(*logs):
        np.testing.assert_allclose(sub, dense, rtol=1e-6)
    shutil.rmtree(tmp_path)  # the checkpoints take 0.8 GB

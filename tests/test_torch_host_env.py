"""The port's host simulator and environment against the JAX package's, step
by step over one fixed action sequence: ``AAViSSSim`` (nodes, rotations,
azimuths, distances, observations and the numpy/scipy ``render_audio_host``)
and ``AAViSSEnv`` (rewards, done, infos, auto-reset and the episode order),
on the synthetic micro-scene and on a file-backed fixture in the reference's
on-disk layout (2 grid scenes of V = 12, RIR length 400). Both packages run
the same numpy on the same data, so everything agrees exactly. Then the
port's ``SyncVectorEnv`` and ``ProcessVectorEnv`` (forked workers) agree
with each other and with the JAX package's."""

import numpy as np
import pytest

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env import bundle as jb
from move2hear_tpu.env.environment import AAViSSEnv as JEnv
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.env.sim import AAViSSSim as JSim
from move2hear_tpu.env.vector_env import SyncVectorEnv as JSyncVectorEnv
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import bundle as tb
from move2hear_tpu_torch.env.environment import AAViSSEnv
from move2hear_tpu_torch.env.layout import write_soundspaces_layout
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.env.sim import AAViSSSim, Action
from move2hear_tpu_torch.env.vector_env import ProcessVectorEnv, SyncVectorEnv, construct_envs
from _torch_threads import cap_torch_threads

cap_torch_threads()

# PAUSE=0, MOVE_FORWARD=1, TURN_LEFT=2, TURN_RIGHT=3
ACTIONS = [1, 1, 2, 1, 3, 3, 1, 0, 1, 2, 2, 1, 1, 3, 1, 1, 0, 2, 1, 1, 3, 1, 2, 1]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{"micro": (port bundle, JAX bundle), "files": (...)}."""
    out = {
        "micro": (build_micro_scene(rows=3, cols=3, num_episodes=8, near_target=False,
                                    rir_length=400),
                  j_build_micro_scene(rows=3, cols=3, num_episodes=8, near_target=False,
                                      rir_length=400)),
    }
    root = tmp_path_factory.mktemp("layout")
    lay = write_soundspaces_layout(root, num_scenes=2, rows=3, cols=4, episodes_per_scene=3,
                                   rir_length=400, splits={"test_farTarget": False}, seed=1)
    opts = lay["opts"] + ["TASK_CONFIG.DATASET.SPLIT", "test_farTarget"]
    exp = "configs/test/farTarget.yaml"
    cfg = get_config(exp, opts, str(root / "run"), "eval")
    j_cfg = j_get_config(exp, opts, str(root / "run"), "eval")
    out["files"] = (tb.bundle_from_config(cfg.TASK_CONFIG, max_rir_length=400),
                    jb.bundle_from_config(j_cfg.TASK_CONFIG, max_rir_length=400))
    return out


def _assert_obs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("data", ["micro", "files"])
def test_sim_steps_equal_jax(bundles, data):
    ours_b, ref_b = bundles[data]
    ours = AAViSSSim(ours_b.scene, ours_b.audio_db, ours_b.frame_cache, eval_mode=True,
                     gt_mono_mag_norm=1.2)
    ref = JSim(ref_b.scene, ref_b.audio_db, ref_b.frame_cache, eval_mode=True,
               gt_mono_mag_norm=1.2)
    for ep_o, ep_r in list(zip(ours_b.episodes.episodes, ref_b.episodes.episodes))[:3]:
        _assert_obs_equal(ours.reset(ep_o), ref.reset(ep_r))
        for i, a in enumerate(ACTIONS):
            _assert_obs_equal(ours.step(a), ref.step(a))
            assert (ours.receiver_node, ours.rotation, ours.azimuth_angle, ours.get_orientation()) \
                == (ref.receiver_node, ref._rotation, ref.azimuth_angle, ref.get_orientation())
            assert ours.geo_dist_to_target() == ref.geo_dist_to_target()
            assert ours.euclid_dist_to_target() == ref.euclid_dist_to_target()
            assert ours.reaching_goal == ref.reaching_goal
            if i % 8 == 0:
                h, j = ours.render_audio_host(), ref.render_audio_host()
                assert sorted(h) == sorted(j)
                for k in h:
                    assert h[k].shape == j[k].shape and h[k].shape[:2] == (512, 32)
                    np.testing.assert_array_equal(h[k], j[k], err_msg=k)
    train = AAViSSSim(ours_b.scene, ours_b.audio_db)
    train.reset(ours_b.episodes.episodes[0])
    with pytest.raises(ValueError, match="PAUSE"):
        train.step(Action.PAUSE)


@pytest.mark.parametrize("data", ["micro", "files"])
def test_env_steps_equal_jax(bundles, data):
    """Distance rewards on, 5-step episodes, shuffled episode order: the
    rewards, done flags, infos, auto-reset observations and episode order
    match over several episodes."""
    ours_b, ref_b = bundles[data]
    kw = dict(max_episode_steps=5, with_distance_reward=True, distance_reward_scale=0.5,
              seed=3, possible_actions=("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"))
    ours = AAViSSEnv(AAViSSSim(ours_b.scene, ours_b.audio_db, ours_b.frame_cache),
                     ours_b.episodes, **kw)
    ref = JEnv(JSim(ref_b.scene, ref_b.audio_db, ref_b.frame_cache), ref_b.episodes, **kw)
    _assert_obs_equal(ours.reset(), ref.reset())
    dones = 0
    for a in ACTIONS * 2:
        a = a % 3
        assert ours.current_episode.episode_id == ref.current_episode.episode_id
        obs, reward, done, info = ours.step(a)
        r_obs, r_reward, r_done, r_info = ref.step(a)
        _assert_obs_equal(obs, r_obs)
        assert (reward, done, info) == (r_reward, r_done, r_info)
        dones += done
    assert dones == len(ACTIONS) * 2 // 5 and ours.number_of_episodes() == ref.number_of_episodes()


def _env_fns(bundle, n):
    return [bundle.make_env_fn(max_episode_steps=4, with_distance_reward=True, seed=i,
                               episodes=bundle.episodes.split_for_rank(i, n))
            for i in range(n)]


def test_sync_and_process_vector_envs_agree(bundles):
    ours_b, ref_b = bundles["files"]
    sync = SyncVectorEnv(_env_fns(ours_b, 2))
    proc = construct_envs(_env_fns(ours_b, 2), use_sync=False)
    ref = JSyncVectorEnv(_env_fns(ref_b, 2))
    try:
        assert isinstance(proc, ProcessVectorEnv) and proc.num_envs == sync.num_envs == 2
        for a, b, c in zip(sync.reset(), proc.reset(), ref.reset()):
            _assert_obs_equal(a, b)
            _assert_obs_equal(a, c)
        for t, a in enumerate(ACTIONS[:10]):
            acts = [a % 3, (a + t) % 3]
            for s, p, r in zip(sync.step(acts), proc.step(acts), ref.step(acts)):
                _assert_obs_equal(s[0], p[0])
                _assert_obs_equal(s[0], r[0])
                assert s[1:] == p[1:] == r[1:]
        assert sync.count_episodes() == proc.count_episodes() == ref.count_episodes() == [3, 3]
        assert sync.call(["number_of_episodes"] * 2) == proc.call(["number_of_episodes"] * 2)
        proc.pause_at(0)
        assert proc.num_envs == 1 and proc.count_episodes() == [3]
        proc.resume_all()
        assert proc.num_envs == 2
    finally:
        procs = list(proc._procs)
        proc.close()
        sync.close()
    assert all(not p.is_alive() for p in procs) and proc.num_envs == 0

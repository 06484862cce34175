"""The port's episode-keyed RIR sub-banks (``env/sub_bank.py``) and the
trainer's dense/sub gate on the CPU, against the JAX package, at the sizes
of tests/test_sub_bank.py: a 2-scene fixture (3x3 and 2x4 grids, RIR length
300), hidden 64, 2 envs, 3 steps.

The host-side bookkeeping (the occupancy mirror, capacities, budgets, the
slots each row goes to) must equal the JAX package's exactly, so that both
packages upload the same rows in the same order. The float32 slab holds the
same values as the dense bank, so the sub-mode gather, and training from it,
are bitwise equal to the dense route. The sub-mode collect agrees with the
JAX package's within tests/test_torch_train_loop.py's tolerances:
spectrograms rtol 2e-3, atol 2e-4 (the render's f16 casts and int16
rounding flips), per-env values 1e-4 relative."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.env import device_env as jde
from move2hear_tpu.env import sub_bank as jsb
from move2hear_tpu.env.audio_db import SyntheticAudioDB as JAudioDB
from move2hear_tpu.env.episodes import EpisodeDataset as JEpisodeDataset
from move2hear_tpu.env.episodes import generate_episodes as j_generate_episodes
from move2hear_tpu.env.frame_cache import SyntheticFrameCache as JFrameCache
from move2hear_tpu.env.micro_scene import MicroSceneBundle as JBundle
from move2hear_tpu.env.micro_scene import build_scale_fixture as j_build_scale_fixture
from move2hear_tpu.env.scene import GraphScene as JGraphScene
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.env import sub_bank as tsb
from move2hear_tpu_torch.env.audio_db import SyntheticAudioDB
from move2hear_tpu_torch.env.episodes import EpisodeDataset, generate_episodes
from move2hear_tpu_torch.env.frame_cache import SyntheticFrameCache
from move2hear_tpu_torch.env.micro_scene import (
    DEFAULT_SOUNDS,
    MicroSceneBundle,
    build_micro_scene,
    build_scale_fixture,
)
from move2hear_tpu_torch.env.scene import GraphScene
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.rl import device_rollout as tdr
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, MAX_STEPS, GT_NORM, R = 64, 2, 3, 3, 1.2, 300
CODES = (1, 2, 3)  # MOVE_FORWARD, TURN_LEFT, TURN_RIGHT
SENSORS = ("mixed_bin_audio_mag", "target_class", "rgb", "depth")
EXP = "configs/train/nearTarget.yaml"


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """The first large CPU call of a torch transcendental in a process with
    JAX loaded can be off by up to 1.5e-4 (ROADMAP Queue 3): call each once."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


def _two_scene(pkg, frames=False):
    """tests/test_sub_bank.py's fixture in the JAX package (`pkg` "jax") or
    the port: scenes 3x3 and 2x4, 6 episodes each, RIR length 300."""
    graph, db, gen, dataset, bundle, cache = (
        (JGraphScene, JAudioDB, j_generate_episodes, JEpisodeDataset, JBundle, JFrameCache)
        if pkg == "jax" else
        (GraphScene, SyntheticAudioDB, generate_episodes, EpisodeDataset, MicroSceneBundle,
         SyntheticFrameCache)
    )
    scene_a, scene_b = graph.grid("sceneA", 3, 3), graph.grid("sceneB", 2, 4)
    eps = (gen(scene_a, DEFAULT_SOUNDS, 6, seed=1, esc_sounds=("esc",)).episodes
           + gen(scene_b, DEFAULT_SOUNDS, 6, seed=2, esc_sounds=("esc",)).episodes)
    return bundle(scene={"sceneA": scene_a, "sceneB": scene_b},
                  audio_db=db(DEFAULT_SOUNDS, rir_length=R),
                  frame_cache=cache() if frames else None, episodes=dataset(eps))


@pytest.fixture(scope="module")
def bundles():
    return _two_scene("jax"), _two_scene("torch")


def _banks(pkg_sb, bundle, dev_eps, order, horizon, t_steps, v_pad, **kw):
    return pkg_sb.RirSubBank(bundle.scenes, bundle.audio_db, np.asarray(dev_eps.scene_idx),
                             np.asarray(dev_eps.sources), order, horizon, t_steps,
                             v_pad=v_pad, **kw)


def _port_bank(bundle, order, horizon, t_steps, **kw):
    eps = de.build_device_episodes(bundle.episodes, bundle.audio_db, bundle.scenes, "cpu")
    v_pad = max(s.num_nodes for s in bundle.scenes.values())
    return _banks(tsb, bundle, eps, order, horizon, t_steps, v_pad, **kw)


def _jax_bank(bundle, order, horizon, t_steps, **kw):
    eps = jde.build_device_episodes(bundle.episodes, bundle.audio_db, bundle.scenes)
    v_pad = max(s.num_nodes for s in bundle.scenes.values())
    return _banks(jsb, bundle, eps, order, horizon, t_steps, v_pad, **kw)


def test_get_rir_block_and_scale_fixture_equal_the_jax_packages():
    ours, ref = SyntheticAudioDB(DEFAULT_SOUNDS, rir_length=R), JAudioDB(DEFAULT_SOUNDS, rir_length=R)
    ours.get_rir("sceneA", 90, 2, 5)  # a cached RIR is read, not made again
    block = ours.get_rir_block("sceneA", 90, 5, 9)
    assert block.shape == (9, R, 2) and block.dtype == np.float32
    stacked = np.stack([ours.get_rir("sceneA", 90, recv, 5) for recv in range(9)])
    assert np.array_equal(block, stacked)
    assert np.array_equal(block, ref.get_rir_block("sceneA", 90, 5, 9))
    for frames in (False, True):
        kw = dict(num_scenes=3, rows=3, cols=4, episodes_per_scene=4, rir_length=64,
                  with_frames=frames, seed=2)
        got, want = build_scale_fixture(**kw), j_build_scale_fixture(**kw)
        assert sorted(got.scenes) == sorted(want.scenes) == ["scale00", "scale01", "scale02"]
        for name, scene in got.scenes.items():
            assert scene.num_nodes == want.scenes[name].num_nodes == 12
            assert scene.neighbors == want.scenes[name].neighbors
        # the port's episodes hold every field of the JAX package's but `info`
        assert [vars(e) for e in got.episodes.episodes] == [
            {k: getattr(e, k) for k in vars(got.episodes.episodes[0])} for e in want.episodes.episodes
        ]
        assert len(got.episodes) == 12
        assert np.array_equal(got.audio_db.mono_bank(), want.audio_db.mono_bank())
        assert (got.frame_cache is None) == (want.frame_cache is None) == (not frames)
        if frames:
            a, b = got.frame_cache.get("scale01", 3, 90), want.frame_cache.get("scale01", 3, 90)
            assert all(np.array_equal(a[k], b[k]) for k in ("rgb", "depth"))


def test_occupancy_equals_the_jax_packages_and_the_ports_env(bundles):
    """The mirror predicts exactly the episodes the port's env_step visits,
    the bootstrap observation after each window included, and every window
    as the JAX package's mirror does."""
    _, bundle = bundles
    dev = de.build_device_bundle(bundle, "cpu", rir_mode="sub")
    n_envs, horizon, t_steps = 3, 4, 6
    order = de.make_order_table(n_envs, len(bundle.episodes), seed=3)
    occ, j_occ = tsb.EpisodeOccupancy(order, horizon), jsb.EpisodeOccupancy(order, horizon)
    for a, b in zip(occ.episodes_by_window(4, t_steps), j_occ.episodes_by_window(4, t_steps)):
        assert np.array_equal(a, b)
    state = de.env_reset_all(dev.scene, dev.episodes, torch.as_tensor(order))
    gen = torch.Generator().manual_seed(0)
    for window in range(5):
        predicted = occ.episodes_for_window(t_steps)
        assert np.array_equal(predicted, j_occ.episodes_for_window(t_steps))
        seen = set(state.ep.tolist())
        for _ in range(t_steps):
            actions = torch.randint(0, 4, (n_envs,), generator=gen)
            state, _ = de.env_step(dev.scene, dev.episodes, state, actions, horizon)
            seen |= set(state.ep.tolist())
        assert seen == set(predicted.tolist()), f"window {window}"
        occ.advance(t_steps)
        j_occ.advance(t_steps)
        assert np.array_equal(occ.cursor, j_occ.cursor) and np.array_equal(occ.step, j_occ.step)
        assert np.array_equal(state.step_count.numpy(), occ.step)
        assert np.array_equal(state.ep.numpy(), order[np.arange(n_envs), occ.cursor % order.shape[1]])


def test_capacity_budget_and_estimates_equal_the_jax_packages(bundles):
    j_bundle, bundle = bundles
    for args in [(2, 2, 3, 4, None), (2, 2, 3, 4, 5), (14, 2, 20, 20, 185), (112, 2, 20, 20, None),
                 (3, 1, 7, 2, 100)]:
        assert tsb.sub_bank_capacity(*args) == jsb.sub_bank_capacity(*args)
    assert tsb.sub_bank_capacity(14, 2, 20, 20, 185) == 70
    for args in [(1000, 10, 4, None), (0, 10, 4, None), (1000, 10, 4, 17), (1000, 10, 25, 17),
                 (40 * 2**30 - 1_102_872_576, 153_600_000, 70, 185)]:
        assert tsb.max_capacity_for_budget(*args) == jsb.max_capacity_for_budget(*args)
    # the scale fixture at the port's 40 GiB budget grows to every key
    assert tsb.max_capacity_for_budget(40 * 2**30 - 1_102_872_576, 153_600_000, 70, 185) == 185
    small = dict(num_scenes=2, rows=3, cols=5, episodes_per_scene=4, rir_length=64)
    pairs = [(bundle, j_bundle), (build_scale_fixture(**small), j_build_scale_fixture(**small))]
    for ours, ref in pairs:
        assert tsb._count_unique_keys(ours) == jsb._count_unique_keys(ref)
        assert tsb.fixed_bank_bytes(ours) == jsb.fixed_bank_bytes(ref)
        for args in [(2, 2, 3, 4), (14, 2, 20, 20), (4, 2, 9, 3)]:
            assert (tsb.estimate_sub_bank_bytes(ours, *args)
                    == jsb.estimate_sub_bank_bytes(ref, *args))


def test_sub_bank_uploads_the_same_rows_as_the_jax_packages_and_beats_lru(bundles):
    """On the order table's cyclic orders at one window's capacity, every
    window's rows go to the same slots, in the same count, as in the JAX
    package; the Belady order uploads fewer rows than LRU would; with a slot
    per key, each row is uploaded once."""
    j_bundle, bundle = bundles
    n_envs, horizon, t_steps = 2, 3, 3
    order = de.make_order_table(n_envs, len(bundle.episodes), seed=7)
    probe, occ = _port_bank(bundle, order, horizon, t_steps), tsb.EpisodeOccupancy(order, horizon)
    windows = []
    for _ in range(24):
        windows.append(probe._keys_for(occ.episodes_for_window(t_steps)))
        occ.advance(t_steps)
    need = max(len(k) for k in windows)

    ours = _port_bank(bundle, order, horizon, t_steps, capacity=need)
    ref = _jax_bank(j_bundle, order, horizon, t_steps, capacity=need)
    for _ in range(24):
        slab, table = ours.rollout_inputs()
        j_slab, _ = ref.rollout_inputs()
        assert ours._slot_key == ref._slot_key
        assert ours.rows_uploaded == ref.rows_uploaded and ours.rows_assembled == ref.rows_assembled
        # the window's table rows name the JAX package's slot of each key
        # (its own table can keep a stale row for an episode that enters
        # the window with every key resident, so it is not compared)
        for e in ours._occ.episodes_for_window(t_steps):
            for j, src in enumerate(ours._ep_sources[e]):
                if src >= 0:
                    key = (int(ours._ep_scene_idx[e]), int(src))
                    assert int(table[e, j]) == ref._key_to_slot[key], f"episode {e} slot {j}"
        ours.advance(t_steps)
        ref.advance(t_steps)
    assert np.array_equal(slab.numpy(), np.asarray(j_slab))
    assert ours.bytes_uploaded == ref.bytes_uploaded == ours.rows_uploaded * 4 * 9 * R * 2 * 4
    assert ours.rows_uploaded > ours.capacity  # capacity binds: rows were evicted

    resident, tick, lru_uploads = {}, 0, 0  # the same accesses against LRU
    for keys in windows:
        tick += 1
        missing = [k for k in keys if k not in resident]
        for k in keys:
            if k in resident:
                resident[k] = tick
        for k in missing:
            if len(resident) >= need:
                del resident[min((kk for kk in resident if kk not in set(keys)), key=resident.get)]
            resident[k] = tick
            lru_uploads += 1
    assert ours.rows_uploaded < lru_uploads

    n_keys = tsb._count_unique_keys(bundle)
    full = _port_bank(bundle, order, horizon, t_steps, capacity=n_keys)
    for _ in range(24):
        full.rollout_inputs()
        full.advance(t_steps)
    assert full.rows_uploaded == n_keys
    with pytest.raises(ValueError, match="SUB_BANK_ROWS"):
        _port_bank(bundle, order, horizon, t_steps, capacity=1).rollout_inputs()


def test_prefetch_makes_rollout_inputs_upload_free(bundles):
    _, bundle = bundles
    order = de.make_order_table(N, len(bundle.episodes), seed=9)
    sub = _port_bank(bundle, order, 3, 4)
    sub.rollout_inputs()
    for _ in range(6):
        sub.advance(4)
        sub.prefetch()
        before = sub.rows_uploaded
        sub.rollout_inputs()
        assert sub.rows_uploaded == before, "prefetch missed rows"
    assert set(sub._keys_for(sub._occ.episodes_for_window(4))) <= set(sub._key_to_slot)
    assert sub.host_s["prefetch"] > 0.0 and sub.prefetch_busy_returns == 0  # no stream on the CPU


def test_sub_gather_is_bitwise_equal_to_the_dense_gather(bundles):
    """Across scene switches and evictions, at a capacity pinned to one
    window's need."""
    _, bundle = bundles
    dense = de.build_device_bundle(bundle, "cpu")
    sub_dev = de.build_device_bundle(bundle, "cpu", rir_mode="sub")
    assert sub_dev.rir_bank is None and sub_dev.rir_rfft_bank is None
    horizon, t_steps = 3, 4
    order = de.make_order_table(N, len(bundle.episodes), seed=5)
    probe, need = _port_bank(bundle, order, horizon, t_steps), 0
    for _ in range(4):
        need = max(need, len(probe._keys_for(probe._occ.episodes_for_window(t_steps))))
        probe.advance(t_steps)
    sub = _port_bank(bundle, order, horizon, t_steps, capacity=need)
    state = de.env_reset_all(dense.scene, dense.episodes, torch.as_tensor(order))
    gen, scenes_seen = torch.Generator().manual_seed(1), set()
    for _ in range(4):
        slab, table = sub.rollout_inputs()
        dev_w = dataclasses.replace(sub_dev, rir_sub_bank=slab, ep_src_row=table)
        for _ in range(t_steps):
            obs = de.observe(dense.episodes, state)
            scenes_seen |= set(obs.scene_idx.tolist())
            assert torch.equal(de.gather_sensors(dev_w, obs)["rirs"],
                               de.gather_sensors(dense, obs)["rirs"])
            state, _ = de.env_step(dense.scene, dense.episodes, state,
                                   torch.randint(1, 4, (N,), generator=gen), horizon)
        sub.advance(t_steps)
    assert sub.rows_uploaded > sub.capacity and scenes_seen == {0, 1}
    with pytest.raises(ValueError, match="rir_mode"):
        de.build_device_bundle(bundle, "cpu", rir_mode="host")


def test_sub_gather_stays_bitwise_equal_when_a_window_brings_no_new_key():
    """The trainer's default micro-scene (4x4, 64 episodes, 16 source
    nodes) with 14 envs and 20-step windows, a slot per key, prefetched as
    the trainer does: from the third window on, episodes enter whose keys
    are all resident, so no row is uploaded for them. Their table rows
    must still be written: every row a window reads names the slot of its
    own (scene, source) key, and the gather equals the dense one at every
    step, the bootstrap observation included."""
    bundle = build_micro_scene(rows=4, cols=4, num_episodes=64, near_target=True, rir_length=64)
    n_envs, horizon, t_steps = 14, 20, 20
    dense = de.build_device_bundle(bundle, "cpu")
    sub_dev = de.build_device_bundle(bundle, "cpu", rir_mode="sub")
    order = de.make_order_table(n_envs, len(bundle.episodes), seed=0)
    sub = _port_bank(bundle, order, horizon, t_steps, capacity=tsb._count_unique_keys(bundle))
    state = de.env_reset_all(dense.scene, dense.episodes, torch.as_tensor(order))
    gen, quiet_windows = torch.Generator().manual_seed(1), 0
    for _ in range(order.shape[1] + 1):
        before = sub.rows_uploaded
        slab, table = sub.rollout_inputs()
        quiet_windows += sub.rows_uploaded == before
        for e in sub._occ.episodes_for_window(t_steps):
            for j, s in enumerate(sub._ep_sources[e]):
                if s >= 0:
                    key = (int(sub._ep_scene_idx[e]), int(s))
                    assert sub._slot_key[int(table[e, j])] == key, f"episode {e} slot {j}"
        dev_w = dataclasses.replace(sub_dev, rir_sub_bank=slab, ep_src_row=table)
        for step in range(t_steps + 1):
            obs = de.observe(dense.episodes, state)
            assert torch.equal(de.gather_sensors(dev_w, obs)["rirs"],
                               de.gather_sensors(dense, obs)["rirs"])
            if step < t_steps:
                state, _ = de.env_step(dense.scene, dense.episodes, state,
                                       torch.randint(1, 4, (n_envs,), generator=gen), horizon)
        sub.advance(t_steps)
        sub.prefetch()
    assert quiet_windows >= 2 and sub.rows_uploaded == sub.capacity


def test_sub_collect_matches_the_jax_sub_collect_and_the_refit_reads_no_rirs():
    """One collect over an episode end (T = MAX_STEPS = 3) in sub mode in
    both packages, the same flax weights and JAX's sampled actions; then the
    port's policy update and refit from it give the same results on a slab
    of NaNs: neither reads the RIRs again."""
    status, jpk._PALLAS_STATUS = jpk._PALLAS_STATUS, {}
    j_bundle = _two_scene("jax", frames=True)
    order = de.make_order_table(N, len(j_bundle.episodes), seed=4)
    with jax.default_matmul_precision("highest"):
        j_policy = JPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=True)
        obs = {
            "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
            "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
            "target_class": jnp.zeros((1, 1), jnp.int32),
        }
        v = jax.jit(j_policy.init)(jax.random.PRNGKey(0), obs, jnp.zeros((1, HID)), jnp.ones((1, 1)))
        j_dev = jde.build_device_bundle(j_bundle, rir_mode="sub")
        j_sub = _jax_bank(j_bundle, order, MAX_STEPS, T)
        slab, table = j_sub.rollout_inputs()
        j_dev = j_dev._replace(rir_sub_bank=slab, ep_src_row=table)
        j_env = jde.env_reset_all(j_dev.scene, j_dev.episodes, jnp.asarray(order))
        collect = jdr.make_collect(j_policy, jppo.PPOConfig(), T, MAX_STEPS, GT_NORM, True, 10.0,
                                   0.0, CODES, SENSORS)
        out = jax.jit(collect)(j_dev, v["params"], v["batch_stats"], j_env, jnp.zeros((N, HID)),
                               jnp.ones((N, 1)), jnp.zeros((N, 512, 32, 1)), jax.random.PRNGKey(1))
        j_pol, j_slab = jax.tree.map(np.asarray, (out.rollouts_pol, out.sep_slab))
    jpk._PALLAS_STATUS = status

    bundle = _two_scene("torch", frames=True)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    policy.load_state_dict(from_jax(v["params"], v["batch_stats"]))
    policy.eval()
    dev = de.build_device_bundle(bundle, "cpu", rir_mode="sub")
    sub = _port_bank(bundle, order, MAX_STEPS, T)
    slab, table = sub.rollout_inputs()
    dev = dataclasses.replace(dev, rir_sub_bank=slab, ep_src_row=table)
    env = de.env_reset_all(dev.scene, dev.episodes, torch.as_tensor(order))
    actions = torch.tensor(j_pol["actions"], dtype=torch.long)
    ours = tdr.make_collect(policy, tppo.PPOConfig(), T, MAX_STEPS, GT_NORM, 10.0, CODES, SENSORS,
                            sampler=lambda dist, t: actions[t])(
        dev, env, torch.zeros((N, HID)), torch.ones((N, 1)), torch.zeros((N, 512, 32, 1)))
    assert j_pol["masks"].min() == 0.0 and len(set(order[:, :2].ravel().tolist())) == 4
    spectrograms = ("pred_binSepMasks", "pred_mono", "prev_pred_monoFromMem",
                    "mixed_bin_audio_mag", "gt_mono", "prev_mem")

    def close(got, want, key):
        got, want = got.to(torch.float32).numpy(), np.asarray(want, np.float32)
        if key in spectrograms:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=key)

    assert np.array_equal(ours.rollouts_pol["masks"].numpy(), j_pol["masks"])
    for k in ("rewards", "value_preds", "returns", "action_log_probs", "pred_binSepMasks",
              "pred_mono", "prev_pred_monoFromMem"):
        close(ours.rollouts_pol[k], j_pol[k], k)
    for k, val in ours.rollouts_pol["observations"].items():
        close(val, j_pol["observations"][k], k)
    for k, val in ours.sep_slab.items():
        close(val, j_slab[k], k)

    cfg = tppo.PPOConfig(ppo_epoch=1)
    results = []
    for poison in (False, True):
        if poison:
            slab.fill_(float("nan"))
        torch.manual_seed(5)
        p = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
        p.load_state_dict(policy.state_dict())
        p.eval()
        state = tppo.create_agent_state(cfg, p)
        buf = tdr.RolloutSepIdx.create(T, N, 2)
        tdr.write_sep_slab(buf, ours.sep_slab, 0)
        gen = torch.Generator().manual_seed(0)
        pol = tppo.make_update_pol(p, cfg, N)(state, ours.rollouts_pol, gen, 1.0, 1.0)
        sep = tdr.make_update_sep_from_slabs(p, cfg, 1)(state, buf, gen, [1.0])
        results.append((pol, sep, p.state_dict()))
    (pol_a, sep_a, sd_a), (pol_b, sep_b, sd_b) = results
    assert torch.isfinite(pol_b).all() and torch.isfinite(sep_b).all()
    assert torch.equal(pol_a, pol_b) and torch.equal(sep_a, sep_b)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


def _tiny_opts(extra=()):
    """tests/test_sub_bank.py's tiny trainer: 2 envs, 3 steps, a horizon of
    4, 2 updates a cycle, 1 PPO epoch, hidden 64."""
    return [
        "NUM_PROCESSES", "2", "NUM_UPDATES", "4", "CHECKPOINT_INTERVAL", "100",
        "LOG_INTERVAL", "100", "RL.PPO.hidden_size", "64", "RL.PPO.num_steps", "3",
        "RL.PPO.num_updates_per_cycle", "2", "RL.PPO.ppo_epoch", "1",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "4",
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", *extra,
    ]


def test_sub_mode_trains_to_the_dense_modes_parameters_bitwise(tmp_path):
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=8, near_target=True, rir_length=R)
    params = {}
    for mode in ("dense", "sub"):
        cfg = get_config(EXP, _tiny_opts(), str(tmp_path / mode), "train")
        trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
        trainer._train_device(rir_mode=mode)
        assert trainer._rir_mode == mode and len(trainer.cycle_log) == 2
        ckpt = os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2.pth")
        params[mode] = load_checkpoint(ckpt)["state_dict"]
    # the budget holds a slot for every key: no row is evicted or uploaded twice
    sub = trainer._sub_bank
    assert sub.capacity == tsb._count_unique_keys(bundle)
    assert sum(c["rows_uploaded"] for c in trainer.sub_bank_log) == sub.rows_uploaded
    assert 0 < sub.rows_uploaded == sub.rows_assembled <= sub.capacity
    for k, v in params["dense"].items():
        assert torch.equal(v, params["sub"][k]), k
    shutil.rmtree(tmp_path)  # the checkpoints, 0.2-0.4 GB each


def test_train_picks_sub_mode_at_scale(tmp_path):
    """8 scenes of V = 300 with R = 256: the dense bank (5.9 GB) exceeds a
    500 MiB budget, the sub-bank fits it, and auto trains on the sub route
    (tests/test_sub_bank.py::test_gate_selects_sub_mode_at_scale)."""
    scenes, eps = {}, []
    for i in range(8):
        name = f"scene{i}"
        scenes[name] = GraphScene.grid(name, 15, 20)
        eps += generate_episodes(scenes[name], DEFAULT_SOUNDS, 3, seed=10 + i,
                                 esc_sounds=("esc",), near_target=True).episodes
    bundle = MicroSceneBundle(scene=scenes, audio_db=SyntheticAudioDB(DEFAULT_SOUNDS, rir_length=256),
                              frame_cache=None, episodes=EpisodeDataset(eps))
    budget = 500 * 2**20
    assert de.estimate_bank_bytes(bundle) > budget >= tsb.estimate_sub_bank_bytes(bundle, 2, 2, 3, 4)
    # the fixture has no frames: the policy takes neither visual modality
    cfg = get_config(EXP, _tiny_opts(["TPU.MAX_DEVICE_BANK_BYTES", str(budget), "EXTRA_RGB", "True",
                                      "EXTRA_DEPTH", "True", "NUM_UPDATES", "2"]),
                     str(tmp_path), "train")
    trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
    trainer.train()
    assert trainer._rir_mode == "sub" and len(trainer.cycle_log) == 1
    row_bytes = 4 * 300 * 256 * 2 * 4
    keys = tsb._count_unique_keys(bundle)
    assert trainer._sub_bank.capacity == tsb.max_capacity_for_budget(
        budget - tsb.fixed_bank_bytes(bundle), row_bytes,
        tsb.sub_bank_capacity(2, 2, 3, 4, keys), keys)
    for pol, sep in trainer.loss_log:
        assert np.isfinite(pol).all() and np.isfinite(sep).all()
    shutil.rmtree(tmp_path)  # the checkpoint, 0.2-0.4 GB

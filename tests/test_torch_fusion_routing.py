"""The routing the JAX package ties to TPU.FUSED_CYCLE and
TPU.PAIRWISE_FUSION, and TPU.COLLECT_UNROLL's values, held against the JAX
trainer on the CPU.

Under either fusion knob the JAX package stores the frames in the rollouts
(no pose bank), skips the preemptive sync, never takes the sub-banks (auto
falls back to the host path, a forced RIR_MODE sub raises ValueError) and
skips REPORT_MFU with a warning; its fused cycle computes the lr and clip
decay in float32 on the device and hands the refit the collects' own
outputs. Each package's trainer runs here until its first collect (the JAX
trainer with its policy's init stubbed, so nothing compiles), and the
decisions it took are compared. COLLECT_UNROLL takes what lax.scan's unroll
takes; the port's collect, a Python loop, trains bitwise alike at every
value. The decay's float32 formula is pinned against JAX's own arithmetic
and against the host's float64 one, which it differs from at some update
indices."""

import logging
import os
import shutil
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import move2hear_tpu.rl.device_rollout as jdr
import move2hear_tpu.rl.trainer as jtrainer
import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.parallel.ddppo import RolloutSyncState as JRolloutSyncState
from move2hear_tpu.utils import tb as jtb
from move2hear_tpu.utils.tb import TensorboardWriter as JTensorboardWriter
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.parallel.ddppo import RolloutSyncState
from move2hear_tpu_torch.rl.trainer import PPOTrainer, refuse_unported_knobs
from move2hear_tpu_torch.utils.misc import linear_decay, linear_decay_float32
from move2hear_tpu_torch.utils.tb import TensorboardWriter
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/train/nearTarget.yaml"
KNOBS = [None, "FUSED_CYCLE", "PAIRWISE_FUSION"]
# 4 envs x 9 steps: the 3x3 scene's 36 poses fit the pose bank
N, T = 4, 9
OPTS = ["NUM_PROCESSES", str(N), "NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1000",
        "LOG_INTERVAL", "1000", "RL.PPO.hidden_size", "32", "RL.PPO.num_steps", str(T),
        "RL.PPO.num_updates_per_cycle", "2", "RL.PPO.ppo_epoch", "1",
        "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
        "RL.PPO.short_rollout_threshold", "0.5", "RL.PPO.sync_frac", "0.5",
        "RL.PPO.pretrained_passive_separators_ckpt", "",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.MAX_RIR_LENGTH", "400",
        "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", "TENSORBOARD_DIR", "tb",
        "TPU.MESH_SHAPE", "[1]"]


class _Stop(Exception):
    """Raised where a trainer would run its first collect."""


class _StubState(NamedTuple):
    """The JAX train state's fields the trainer reads before its first
    program, as a pytree."""
    params: dict
    batch_stats: dict


class _FixedStore:
    def add(self, generation):
        return 0

    def get(self, generation):
        return 0

    def close(self):
        pass


def _knob(knob):
    return [f"TPU.{knob}", "True"] if knob else []


def _stopping(*args, **kwargs):
    def run(*a, **k):
        raise _Stop
    return run


@pytest.fixture
def probes(tmp_path, monkeypatch):
    """(jax_probe, port_probe): each builds its package's trainer for the
    config opts on the 3x3 micro-scene, in a mocked world of 4 ranks (rank
    0; the sync's store a fixed one), runs ``train()`` until the first
    collect and returns what it decided: the route, whether the rollouts
    store pose indices, whether the preemptive sync was made, mfu_info, and
    the trainer. The route functions run as they are unless `stub_routes`,
    where they only record the route."""
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    monkeypatch.setenv("INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
    # nothing compiles: the JAX policy's init, its train state and the
    # programs are stubbed, and the first collect stops the run
    monkeypatch.setattr(jtrainer.Move2HearPolicy, "init", lambda self, *a, **k: {})
    monkeypatch.setattr(jtrainer, "create_agent_state",
                        lambda cfg, v: _StubState({}, {}))
    monkeypatch.setattr(jtrainer, "replicate", lambda mesh, tree: tree)
    for name in ("make_collect", "make_train_cycle", "make_collect_and_update"):
        monkeypatch.setattr(jdr, name, _stopping)
    monkeypatch.setattr(ttrainer, "make_collect", _stopping)
    monkeypatch.setattr(jtb, "TensorboardWriter", lambda *a, **k: JTensorboardWriter(""))
    monkeypatch.setattr(ttrainer, "TensorboardWriter", lambda *a, **k: TensorboardWriter(""))
    monkeypatch.setattr(jtrainer, "get_distrib_info", lambda: (0, 0, 4))
    monkeypatch.setattr(ttrainer, "get_distrib_info", lambda: (0, 0, 4))

    def run(pkg, opts, rows, stub_routes):
        made = []
        mod = jtrainer if pkg == "jax" else ttrainer
        sync_cls = JRolloutSyncState if pkg == "jax" else RolloutSyncState

        def make_sync(self, t):
            made.append(t)
            return sync_cls(0.5, 0.5, t, 4, store=_FixedStore())

        monkeypatch.setattr(mod.PPOTrainer, "_make_rollout_sync", make_sync)
        routes = []
        if stub_routes:
            monkeypatch.setattr(mod.PPOTrainer, "_train_host",
                                lambda self: routes.append("host"))
            monkeypatch.setattr(mod.PPOTrainer, "_train_device",
                                lambda self, rir_mode="dense": routes.append(rir_mode))
        model_dir = str(tmp_path / pkg)
        if pkg == "jax":
            trainer = jtrainer.PPOTrainer(j_get_config(EXP, [*OPTS, *opts], model_dir, "train"),
                                          bundle=j_build_micro_scene(**rows))
        else:
            trainer = PPOTrainer(get_config(EXP, [*OPTS, *opts], model_dir, "train"),
                                 bundle=build_micro_scene(**rows), device="cpu")
        try:
            trainer.train()
        except _Stop:
            pass
        return SimpleNamespace(
            route=routes[0] if routes else getattr(trainer, "_rir_mode", None),
            pose_obs=getattr(trainer, "_pose_obs", None), sync=bool(made),
            mfu_info=getattr(trainer, "mfu_info", "unset"), trainer=trainer)

    scene = dict(rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400)

    def probe(pkg, opts=(), rows=scene, stub_routes=False):
        return run(pkg, opts, rows, stub_routes)

    return probe


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: k or "default")
def test_pose_obs_and_the_sync_follow_the_jax_trainer(probes, knob):
    """A fusion knob stores the frames and keeps the rollouts whole in a
    world where the sync would cut them; the default route takes the pose
    bank and the sync."""
    j, ours = probes("jax", _knob(knob)), probes("port", _knob(knob))
    assert (ours.route, ours.pose_obs, ours.sync) == (j.route, j.pose_obs, j.sync)
    assert (ours.pose_obs, ours.sync) == ((False, False) if knob else (True, True))


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: k or "default")
def test_the_auto_gate_skips_the_sub_banks_under_a_fusion_knob(probes, knob):
    """A 4x4 scene whose dense banks (11.4 MB) exceed the budget and whose
    sub-bank (10.2 MB) fits it: auto takes sub on the default route and the
    host path under either knob, in both packages."""
    rows = dict(rows=4, cols=4, num_episodes=8, near_target=True, rir_length=400)
    opts = ["TPU.MAX_DEVICE_BANK_BYTES", "10500000", "NUM_PROCESSES", "2", "RL.PPO.num_steps",
            "3", *_knob(knob)]
    with pytest.MonkeyPatch.context() as mp:
        # a world of one: the JAX gate sizes the sub-bank for the world's envs
        # (one program over the mesh), the port's for a rank's
        for mod in (jtrainer, ttrainer):
            mp.setattr(mod, "get_distrib_info", lambda: (0, 0, 1))
        j = probes("jax", opts, rows=rows, stub_routes=True)
        ours = probes("port", opts, rows=rows, stub_routes=True)
    assert ours.route == j.route == ("host" if knob else "sub")


@pytest.mark.parametrize("knob", KNOBS[1:])
def test_a_forced_sub_route_raises_the_jax_packages_error(probes, knob):
    opts = ["TPU.RIR_MODE", "sub", *_knob(knob)]
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="cannot host the refresh") as err:
            probes(pkg, opts)
        if pkg == "jax":
            j_msg = str(err.value)
    assert str(err.value) == j_msg


@pytest.mark.parametrize("knob", KNOBS[1:])
def test_report_mfu_is_skipped_with_the_jax_packages_warning(probes, knob, caplog):
    """In a world of one (the JAX probe counts only there)."""
    opts = ["TPU.REPORT_MFU", "True", *_knob(knob)]
    warning = "REPORT_MFU: probe supports single-device separate-program runs only; skipping"
    for pkg, mod in (("jax", jtrainer), ("port", ttrainer)):
        caplog.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "get_distrib_info", lambda: (0, 0, 1))
            with caplog.at_level(logging.WARNING):
                out = probes(pkg, opts)
        assert out.mfu_info is None, pkg
        assert warning in caplog.text, pkg


@pytest.mark.parametrize("unroll", [-1, -4, 0, 1, 4])
def test_collect_unroll_takes_what_lax_scan_takes(tmp_path, unroll):
    """The JAX package hands int(COLLECT_UNROLL) to lax.scan: a negative
    unroll raises ValueError there, and in the port at config time, before
    any training; 0 and positive counts are accepted."""
    def scan():
        return jax.lax.scan(lambda c, x: (c + x, c), 0.0, jnp.arange(3.0), unroll=unroll)

    cfg = get_config(EXP, [*OPTS, "TPU.COLLECT_UNROLL", str(unroll)], str(tmp_path), "train")
    if unroll < 0:
        with pytest.raises(ValueError):
            scan()
        with pytest.raises(ValueError, match="COLLECT_UNROLL"):
            refuse_unported_knobs(cfg.TPU)
        with pytest.raises(ValueError, match="COLLECT_UNROLL"):
            PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                     rir_length=400), device="cpu").train()
        assert not os.path.exists(cfg.CHECKPOINT_FOLDER)
    else:
        scan()
        refuse_unported_knobs(cfg.TPU)
    refuse_unported_knobs(cfg.TPU, training=False)  # evaluation reads no unroll


def _tiny_run(tmp_path, opts, tag):
    """A 2-env, 3-step run of one cycle of 2 updates on the 3x3 scene;
    returns (state dict, loss log)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "TensorboardWriter", lambda *a, **k: TensorboardWriter(""))
        cfg = get_config(EXP, [*OPTS, "NUM_PROCESSES", "2", "RL.PPO.num_steps", "3",
                               "RL.PPO.use_ddppo", "False", *opts], str(tmp_path / tag), "train")
        trainer = PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                           rir_length=400), device="cpu")
        trainer.train()
    shutil.rmtree(cfg.CHECKPOINT_FOLDER)  # a checkpoint takes 0.2-0.4 GB
    return trainer.final_policy.state_dict(), trainer.loss_log


def test_collect_unroll_trains_bitwise_as_unroll_1(tmp_path, caplog):
    ref_params, ref_losses = _tiny_run(tmp_path, [], "unroll1")
    for unroll in ("0", "4"):
        with caplog.at_level(logging.INFO, logger=ttrainer.__name__):
            params, losses = _tiny_run(tmp_path, ["TPU.COLLECT_UNROLL", unroll], f"unroll{unroll}")
        assert f"TPU.COLLECT_UNROLL={unroll}" in caplog.text
        for k, v in ref_params.items():
            assert torch.equal(params[k], v), (unroll, k)
        for (pol, sep), (rpol, rsep) in zip(losses, ref_losses):
            np.testing.assert_array_equal(pol, rpol)
            np.testing.assert_array_equal(sep, rsep)


@pytest.mark.parametrize("total,differs", [(2, []), (4, []), (6, [2, 4, 5]),
                                           (12, [4, 5, 7, 8, 10, 11])])
def test_the_fused_decay_is_the_jax_fused_cycles_float32_formula(total, differs):
    """The fused cycle's 1.0 - idx.astype(float32) / num_updates_total
    (move2hear_tpu/rl/device_rollout.py:685-686) as JAX computes it equals
    linear_decay_float32 bitwise, and differs from the host's float64
    linear_decay rounded to float32 at the pinned indices of the test and
    chip configs' NUM_UPDATES."""
    idx = jnp.arange(total)
    fused = np.asarray(1.0 - idx.astype(jnp.float32) / total)
    ours = np.asarray([linear_decay_float32(i, total) for i in range(total)], np.float32)
    host = np.asarray([linear_decay(i, total) for i in range(total)], np.float32)
    np.testing.assert_array_equal(ours, fused)
    assert [i for i in range(total) if host[i] != ours[i]] == differs


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: k or "default")
def test_the_trainer_hands_the_updates_the_decay_of_its_route(tmp_path, monkeypatch, knob):
    """NUM_UPDATES 6 in cycles of 3: FUSED_CYCLE hands the policy updates
    (lr and clip) and the refit the float32 formula, the other routes the
    float64 one; at updates 2, 4 and 5 the two differ."""
    seen = {"lr": [], "clip": [], "sep": []}
    make_pol, make_sep = ttrainer.make_update_pol, ttrainer.make_update_sep_from_slabs

    def pol(*args, **kwargs):
        update = make_pol(*args, **kwargs)

        def run(state, rollouts, generator, lr_scale, clip_scale, **kw):
            seen["lr"].append(lr_scale)
            seen["clip"].append(clip_scale)
            return update(state, rollouts, generator, lr_scale, clip_scale, **kw)
        return run

    def sep(*args, **kwargs):
        update = make_sep(*args, **kwargs)

        def run(state, buf, generator, lr_scales, **kw):
            seen["sep"] += list(lr_scales)
            return update(state, buf, generator, lr_scales, **kw)
        return run

    monkeypatch.setattr(ttrainer, "make_update_pol", pol)
    monkeypatch.setattr(ttrainer, "make_update_sep_from_slabs", sep)
    _tiny_run(tmp_path, ["NUM_UPDATES", "6", "RL.PPO.num_updates_per_cycle", "3",
                         "RL.PPO.num_steps", "2",
                         "RL.PPO.use_linear_lr_decay", "True",
                         "RL.PPO.use_linear_clip_decay", "True", *_knob(knob)], "decay")
    decay = linear_decay_float32 if knob == "FUSED_CYCLE" else linear_decay
    want = [decay(i, 6) for i in range(6)]
    assert seen == {"lr": want, "clip": want, "sep": want}
    assert [i for i in range(6)
            if np.float32(linear_decay(i, 6)) != np.float32(linear_decay_float32(i, 6))] == [2, 4, 5]


@pytest.mark.parametrize("knob,dtype", [("FUSED_CYCLE", torch.float32),
                                        ("PAIRWISE_FUSION", torch.bfloat16), (None, torch.bfloat16)],
                         ids=["FUSED_CYCLE", "PAIRWISE_FUSION", "default"])
def test_the_fused_cycle_leaves_the_refit_slabs_unrounded(probes, knob, dtype):
    """SEP_SLAB_DTYPE bfloat16 rounds the refit's slabs on the separate and
    pairwise routes (the JAX package's write_sep_slab casts to the buffer),
    while its fused cycle hands the refit the collects' outputs
    (make_train_cycle's scan outputs): the port holds them in float32."""
    made = []
    create = ttrainer.RolloutSepIdx.create

    def recording(*args, **kwargs):
        made.append(kwargs["slab_dtype"])
        return create(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer.RolloutSepIdx, "create", recording)
        probes("port", ["TPU.SEP_SLAB_DTYPE", "bfloat16", *_knob(knob)])
    assert made == [dtype]

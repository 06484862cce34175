"""The trainer's routes and the JAX package's TPU knobs on the CPU: the
routes the port does not take are refused before any training, the host and
sub-bank routes train, and the dtype knobs and REPORT_MFU are accepted in
training and evaluation (split from tests/test_torch_train_loop.py)."""

import os
import shutil

import numpy as np
import pytest
import torch

from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.rl.trainer import PPOTrainer, refuse_unported_knobs
from move2hear_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_train_loop import (
    HID,
    EXP,
    KNOBS_PORTED,
    KNOBS_REFUSED_BY_EVAL,
    _train_opts,
    _warm_torch_cpu_math,
)
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("opts,env", [
    *[(o, {}) for o in KNOBS_REFUSED_BY_EVAL],
    (["RL.PPO.nav_reward_weight", "0.5", "RL.PPO.sep_reward_weight", "0.5"], {}),
])
def test_train_refuses_the_routes_not_ported(tmp_path, monkeypatch, opts, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = get_config(EXP, _train_opts(4) + opts, str(tmp_path), "train")
    with pytest.raises(NotImplementedError, match="reward|one rank per"):
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
    shutil.rmtree(cfg.CHECKPOINT_FOLDER)  # a checkpoint takes 0.2-0.4 GB


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
    with pytest.raises(NotImplementedError, match="one rank per"):
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

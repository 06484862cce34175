"""The eval routing on the CPU: the device evaluator or the host evaluator by
TPU.DEVICE_ENV, the episode count and the bank budget, and file-backed data
read through the checkpoint's merged config (split from
tests/test_torch_host_eval.py)."""

import os
import pickle

import numpy as np
import pytest

from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import bundle as tb
from move2hear_tpu_torch.env.layout import write_soundspaces_layout
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from test_torch_host_eval import EVAL_SMALL, NEAR, _ckpt, _warm_torch_cpu_math
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("opts,route", [
    ([], "host"),  # 2 episodes, below TPU.DEVICE_EVAL_MIN_EPISODES (64)
    (["TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_DEVICE_BANK_BYTES", "1000"], "host"),
    (["TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.DEVICE_ENV", "False"], "host"),
    (["TPU.DEVICE_EVAL_MIN_EPISODES", "2"], "device"),
], ids=["below_min_episodes", "over_budget", "device_env_off", "device"])
def test_eval_routes_host_or_device(tmp_path, opts, route):
    cfg = get_config(NEAR, EVAL_SMALL + opts, str(tmp_path), "eval")
    trainer = PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=4,
                                                       rir_length=400), device="cpu")
    ckpt = _ckpt(tmp_path, {})
    agg = trainer._eval_checkpoint(ckpt)
    os.remove(ckpt)  # 0.2 GB
    assert trainer._eval_route == route
    assert trainer.last_eval[1]["episodes"] == 2 and np.isfinite(agg["mono_l2_last"]["mean"])
    assert os.path.exists(tmp_path / "test_nearTarget_stats_ckpt_0_0.json")


def test_eval_reads_file_backed_data_of_the_merged_config(tmp_path):
    """The checkpoint was trained on file-backed data given as CLI opts; the
    eval command names none. The merged config (eval CLI opts > checkpoint
    CLI opts > eval yaml > checkpoint config) points at the fixture's
    test_nearTarget split, and the evaluation reads its scenes."""
    lay = write_soundspaces_layout(tmp_path / "layout", num_scenes=2, rows=3, cols=4,
                                   episodes_per_scene=1, rir_length=400,
                                   splits={"train_nearTarget": True, "test_nearTarget": True})
    train_cfg = get_config("configs/train/nearTarget.yaml", lay["opts"], str(tmp_path / "t"),
                           "train")
    ckpt = _ckpt(tmp_path, train_cfg.to_dict())
    assert not tb.has_file_backed_data(get_config(NEAR, [], str(tmp_path), "eval").TASK_CONFIG)
    cfg = get_config(NEAR, EVAL_SMALL + ["VIDEO_OPTION", "['disk']"], str(tmp_path / "ev"),
                     "eval")
    trainer = PPOTrainer(cfg, device="cpu")
    trainer._eval_checkpoint(ckpt)
    os.remove(ckpt)  # 0.2 GB
    assert trainer._eval_route == "host"
    with open(tmp_path / "ev" / "eval_metrics_ckpt_0.pkl", "rb") as f:
        keys = sorted(pickle.load(f))
    assert keys == ["('scene00', '0')", "('scene01', '0')"]
    # VIDEO_OPTION disk: each episode's rgb frames, one a step
    videos = sorted(os.listdir(tmp_path / "ev" / "videos"))
    assert videos == ["ep_scene00_0.npy", "ep_scene01_0.npy"]
    frames = np.load(tmp_path / "ev" / "videos" / videos[0])
    assert frames.shape == (2, 128, 128, 3) and frames.dtype == np.uint8

"""The pretrain CLI on the CPU: pretrain, evaluate and start RL training from
its checkpoint; the routes it refuses, bfloat16 compute, and file-backed
sources (split from tests/test_torch_pretrain.py)."""

import os
import shutil

import numpy as np
import pytest
import torch

from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.main import main
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.pretrain import trainer as tpt
from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_pretrain import (
    EXP,
    _precise_matmuls_and_plain_route,
    _warm_torch_cpu_math,
    small_sources,
)
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_cli_pretrain_evaluate_and_start_rl_training(tmp_path, monkeypatch):
    """``main --run-type train`` of the pretrain config on the CPU (BATCH_SIZE
    4, 2 epochs, small sources) writes both best checkpoints; ``--run-type
    eval`` on their directory writes a result beside each; the RL trainer
    loads one through RL.PPO.pretrained_passive_separators_ckpt (weights and
    BatchNorm statistics) and trains a shrunken cycle with it frozen."""
    monkeypatch.setattr(tpt.PassiveTrainer, "_default_sources",
                        lambda self: small_sources(SyntheticPassiveSource))
    pre = tmp_path / "pre"
    kernels.reset_launch_counts()
    trainer = main(["--run-type", "train", "--exp-config", EXP, "--model-dir", str(pre),
                    "--device", "cpu", "Pretrain.Passive.BATCH_SIZE", "4",
                    "Pretrain.Passive.NUM_EPOCHS", "2"])
    assert isinstance(trainer, tpt.PassiveTrainer)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    assert len(trainer._val_history) == len(trainer.epoch_log) == 2
    ckpt_dir = trainer.config.CHECKPOINT_FOLDER
    assert sorted(os.listdir(ckpt_dir)) == ["best_ckpt_nonoverlapping_val.pth", "best_ckpt_val.pth"]
    best = os.path.join(ckpt_dir, "best_ckpt_nonoverlapping_val.pth")
    ckpt = load_checkpoint(best)
    assert set(ckpt) == {"state_dict", "optimizer", "extra_state", "config"}
    assert {k.split(".")[0] for k in ckpt["state_dict"]} == set(tppo.PASSIVE_KEYS)
    assert ckpt["extra_state"]["epoch"] in (0, 1)
    sd = ckpt["state_dict"]
    assert all(sd[k].any() for k in sd if k.endswith("running_mean"))  # BN statistics moved

    ev = main(["--run-type", "eval", "--exp-config", EXP, "--model-dir", str(tmp_path / "ev"),
               "--device", "cpu", "Pretrain.Passive.BATCH_SIZE", "4",
               "EVAL_CKPT_PATH_DIR", ckpt_dir])
    assert sorted(ev.last_eval) == sorted(os.path.join(ckpt_dir, f) for f in (
        "best_ckpt_nonoverlapping_val.pth", "best_ckpt_val.pth"))
    for path, res in ev.last_eval.items():
        assert os.path.exists(path + ".eval.json")
        assert all(np.isfinite(v) for split in res.values() for v in split.values())
    # the epoch of the best nonoverlapping-val checkpoint reads its own loss again
    e = ckpt["extra_state"]["epoch"]
    assert ev.last_eval[best]["nonoverlapping_val"]["mono_loss"] == pytest.approx(
        trainer._val_history[e]["nonoverlapping_val"][1], rel=1e-5)

    from move2hear_tpu_torch.env.micro_scene import build_micro_scene
    from move2hear_tpu_torch.rl.trainer import PPOTrainer

    rl_cfg = get_config("configs/train/nearTarget.yaml", [
        "NUM_PROCESSES", "2", "NUM_UPDATES", "2", "RL.PPO.hidden_size", "64",
        "RL.PPO.num_steps", "3", "RL.PPO.num_updates_per_cycle", "2", "RL.PPO.ppo_epoch", "1",
        "RL.PPO.pretrained_passive_separators_ckpt", best,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
    ], str(tmp_path / "rl"), "train")
    rl = PPOTrainer(rl_cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=4,
                                                      rir_length=400), device="cpu")
    rl.train()
    last = load_checkpoint(os.path.join(rl_cfg.CHECKPOINT_FOLDER, "ckpt.1.pth"))["state_dict"]
    for k, v in sd.items():
        assert torch.equal(last[k], v), k  # loaded, then frozen on running statistics
    fresh = rl._new_policy().state_dict()
    assert not torch.equal(last["binSep_enc.cnn.0.0.weight"], fresh["binSep_enc.cnn.0.0.weight"])
    shutil.rmtree(tmp_path)  # the checkpoints take 0.7 GB


@pytest.mark.parametrize("opts,error", [
    (["TPU.COMPUTE_DTYPE", "float16"], ValueError),
    (["TPU.MESH_SHAPE", "[2]"], NotImplementedError),
    (["CUDA"], RuntimeError),
])
def test_pretrain_refuses_the_routes_not_ported(tmp_path, opts, error):
    device = "cpu"
    if opts == ["CUDA"]:
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the trainer runs there")
        opts, device = [], "cuda"
    cfg = get_config(EXP, opts, str(tmp_path / "run"), "train")
    with pytest.raises(error):
        tpt.PassiveTrainer(cfg, device=device)


def test_pretrain_takes_compute_dtype_bfloat16(tmp_path):
    """TPU.COMPUTE_DTYPE bfloat16, refused before it was ported, builds the
    passive policy in bfloat16 compute with float32 parameters."""
    cfg = get_config(EXP, ["TPU.COMPUTE_DTYPE", "bfloat16"], str(tmp_path / "run"), "train")
    trainer = tpt.PassiveTrainer(cfg, device="cpu")
    policy = trainer.new_policy()
    assert policy.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in policy.parameters())
    assert policy.binSep_enc.cnn[0][0].compute_dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["FILES"])
def test_pretrain_reads_file_backed_data(tmp_path, case):
    """The reference's on-disk passive layout (datapoint pickles, RIR wavs,
    class-named audio) is read by FilePassiveSource for every split; one
    epoch trains on it and writes both best checkpoints."""
    from move2hear_tpu_torch.env.layout import write_soundspaces_layout
    from move2hear_tpu_torch.pretrain.dataset import FilePassiveSource

    lay = write_soundspaces_layout(tmp_path / "layout", num_scenes=2, rows=2, cols=2,
                                   rir_length=400, passive_datapoints=4, splits={})
    cfg = get_config(EXP, lay["opts"] + ["Pretrain.Passive.NUM_EPOCHS", "1",
                                         "Pretrain.Passive.BATCH_SIZE", "4"],
                     str(tmp_path / "run"), "train")
    trainer = tpt.PassiveTrainer(cfg, device="cpu")
    assert {k: type(v) for k, v in trainer._sources.items()} == dict.fromkeys(
        ("train", "val", "nonoverlapping_val"), FilePassiveSource)
    trainer.train()
    assert sorted(os.listdir(cfg.CHECKPOINT_FOLDER)) == ["best_ckpt_nonoverlapping_val.pth",
                                                         "best_ckpt_val.pth"]
    shutil.rmtree(tmp_path)  # the checkpoints take 0.7 GB

"""chip_smoke.py's pretrain, pretrain-eval and pretrain-parity phases run
small on the CPU (both devices the CPU, BATCH_SIZE 4; train 8, val 4 and
nonoverlapping-val 4 datapoints, RIR length 500), so their own logic is
tested before a card runs them. The CPU tensors take the kernels' plain
versions, so every launch count reads 0."""

import shutil

import torch

import chip_smoke
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.pretrain import trainer as tpt
from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource
from _torch_threads import cap_torch_threads

cap_torch_threads()

B = 4


def small_sources():
    return {
        "train": SyntheticPassiveSource(num_datapoints=8, rir_length=500, seed=0),
        "val": SyntheticPassiveSource(num_datapoints=4, rir_length=500, seed=1),
        "nonoverlapping_val": SyntheticPassiveSource(num_datapoints=4, rir_length=500, seed=2),
    }


def test_chip_smoke_pretrain_phases_run_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tpt.PassiveTrainer, "_default_sources", lambda self: small_sources())
    zeros = dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    run_dir = str(tmp_path / "smoke")
    counts, ckpt_dir = chip_smoke.pretrain_phase(
        torch, kernels, "cpu", run_dir, device="cpu", opts=["Pretrain.Passive.BATCH_SIZE", str(B)],
        launches=zeros)
    assert counts == zeros
    assert chip_smoke.pretrain_eval_phase(
        torch, kernels, ckpt_dir, run_dir, device="cpu",
        opts=["Pretrain.Passive.BATCH_SIZE", str(B)], launches=zeros) == zeros
    chip_smoke.pretrain_parity_phase(torch, devices=("cpu", "cpu"), b=B)
    out = capsys.readouterr().out
    assert "warm pretrain" in out and "[pretrain-eval]" in out and "[pretrain-parity]" in out
    shutil.rmtree(run_dir)

"""chip_smoke.py's phase 8m pretrain and bf16-parity, small and on the CPU
(both devices the CPU, the plain kernels, so no launch counts), so that
their own logic is tested before a card runs them (split from
tests/test_torch_bf16_smoke.py)."""

import shutil

import torch

import chip_smoke
from move2hear_tpu_torch.ops import kernels
from test_torch_bf16_smoke import HID, zero
from _torch_quick import skip_setup_costs
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_bf16_pretrain_and_parity_phases_run_on_the_cpu(tmp_path, capsys, monkeypatch, zero):
    skip_setup_costs(monkeypatch)
    stats = {}
    counts, folder = chip_smoke.pretrain_phase(
        torch, kernels, "cpu", str(tmp_path / "pre"), device="cpu",
        opts=["Pretrain.Passive.BATCH_SIZE", "4", "TPU.COMPUTE_DTYPE", "bfloat16"],
        launches=zero, label="bf16-pretrain", epochs=2, stats=stats)
    assert counts == zero and stats["warm_rate"] > 0
    chip_smoke.bf16_parity_phase(torch, devices=("cpu", "cpu"), b=2, hid=HID)
    out = capsys.readouterr().out
    assert "[bf16-pretrain] epoch 1 (warm)" in out and "[bf16-parity]" in out
    shutil.rmtree(tmp_path)

"""chip_smoke.py's train phases (8 and 8a, 8d's scale-train with its parity
checks), small and on the CPU (the plain kernels, so no launch counts), so
that their own logic is tested before a card runs them (split from
tests/test_torch_train_loop.py)."""

import os
import shutil

import torch

from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_train_loop import HID, N, T, MAX_STEPS, _warm_torch_cpu_math
from _torch_quick import skip_setup_costs
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_chip_smoke_train_phases_run_on_the_cpu(tmp_path, capsys, monkeypatch):
    """chip_smoke.py's train, far-train, switch merge and far-eval,
    switch-parity and train-parity phases, small and on the CPU (both
    devices the CPU), so their own logic is tested before a card runs
    them."""
    skip_setup_costs(monkeypatch)
    import chip_smoke

    run_dir = str(tmp_path / "smoke")
    os.makedirs(run_dir)
    opts = ["NUM_PROCESSES", str(N), "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", str(T),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(MAX_STEPS),
            "TPU.MAX_RIR_LENGTH", "400", "EVAL_EPISODE_COUNT", "2",
            "TPU.DEVICE_EVAL_MIN_EPISODES", "2"]
    zero = dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    counts, near_ckpt, _ = chip_smoke.train_phase(torch, kernels, "cpu", run_dir,
                                                  device="cpu", opts=opts, launches=zero)
    assert counts == zero
    chip_smoke.train_eval_phase(run_dir, near_ckpt, device="cpu", opts=opts)
    far_counts, far_ckpt, far_trainer = chip_smoke.train_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "far"), label="far-train",
        exp=chip_smoke.FAR_TRAIN_EXP, device="cpu", opts=opts, launches=zero)
    assert far_counts == zero and far_ckpt != near_ckpt
    chip_smoke.require_nav_rewards(far_trainer)
    assert load_checkpoint(far_ckpt)["config"]["RL"]["PPO"]["nav_reward_weight"] == 1.0
    eval_counts = chip_smoke.far_eval_phase(
        torch, kernels, "cpu", run_dir, far_ckpt, near_ckpt, device="cpu", launches=zero,
        episodes=2, opts=["EVAL_EPISODE_COUNT", "2", "TPU.DEVICE_EVAL_MIN_EPISODES", "2",
                          "TPU.MAX_RIR_LENGTH", "400", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS",
                          "4", "RL.PPO.time_thres_for_pol_switch", "2"])
    assert eval_counts == zero
    chip_smoke.parity_phase(torch, switch=True, devices=("cpu", "cpu"), n_envs=2, hid=HID)
    # scale-train on a 2-scene fixture under a budget between its sub-bank
    # and its dense banks, so that the gate chooses the sub-banks
    from move2hear_tpu_torch.env.micro_scene import build_scale_fixture
    from move2hear_tpu_torch.env.sub_bank import estimate_sub_bank_bytes

    small = dict(num_scenes=2, rows=3, cols=4, episodes_per_scene=6, rir_length=400,
                 with_frames=True)
    fixture = build_scale_fixture(**small)
    budget = (estimate_sub_bank_bytes(fixture, N, 2, T, MAX_STEPS)
              + de.estimate_bank_bytes(fixture)) // 2
    assert estimate_sub_bank_bytes(fixture, N, 2, T, MAX_STEPS) < budget < de.estimate_bank_bytes(fixture)
    scale_counts = chip_smoke.scale_train_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "scale"), device="cpu",
        opts=opts + ["TPU.MAX_DEVICE_BANK_BYTES", str(budget)], launches=zero, fixture=small)
    assert scale_counts == zero
    chip_smoke.scale_parity_phase(torch, os.path.join(run_dir, "scale_parity"), device="cpu",
                                  opts=opts, fixture=small, t=MAX_STEPS, n=N, hid=HID)
    chip_smoke.train_parity_phase(torch, devices=("cpu", "cpu"), t=T, n=N, hid=HID)
    out = capsys.readouterr().out
    assert "cycle 1 (warm)" in out and "eval of ckpt.2.pth" in out and "[train-parity]" in out
    assert "[far-train] cycle 1 (warm)" in out and "far-train-path launches" in out
    assert "merged ckpt.2.pth (navigation)" in out and "[far-eval] run warm" in out
    assert "switch at step 2" in out and "[switch-parity]" in out
    assert "[scale-train] cycle 1 (warm)" in out and "scale-train-path launches" in out
    assert "bitwise equal to the rows assembled anew" in out
    assert "mixture magnitudes bitwise equal" in out and "parameters bitwise equal" in out
    assert "slab gathers bitwise equal to dense at every step" in out
    shutil.rmtree(run_dir)

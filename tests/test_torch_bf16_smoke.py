"""chip_smoke.py's bfloat16 phases (8j bf16-train with its eval, 8k
bench-shape, 8l bf16-sub, 8m bf16-pretrain, bf16-parity and the bfloat16
host eval), small and on the CPU (both devices the CPU, the plain kernels,
so no launch counts), so that their own logic is tested before a card runs
them; 8m's pretrain and bf16-parity in test_torch_bf16_pretrain_smoke.py."""

import os
import shutil

import pytest
import torch

import chip_smoke
from move2hear_tpu_torch.ops import kernels
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID = 64
SMALL = ["NUM_PROCESSES", "2", "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", "3",
         "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.MAX_RIR_LENGTH", "400",
         "EVAL_EPISODE_COUNT", "2", "TPU.DEVICE_EVAL_MIN_EPISODES", "2"]


@pytest.fixture
def zero():
    return dict.fromkeys(kernels.launch_counts(variants=True), 0)


def test_bf16_train_bench_and_sub_phases_run_on_the_cpu(tmp_path, capsys, zero):
    run_dir = str(tmp_path / "smoke")
    counts, ckpt = chip_smoke.bf16_train_phase(torch, kernels, "cpu", os.path.join(run_dir, "bf16"),
                                               "", 100.0, device="cpu", opts=SMALL, launches=zero)
    assert counts == zero
    bench = chip_smoke.bench_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "bench"), device="cpu", launches=zero,
        opts=["NUM_PROCESSES", "2", "RL.PPO.hidden_size", str(HID), "RL.PPO.num_steps", "2",
              "RL.PPO.ppo_epoch", "1", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
              "NUM_UPDATES", "2", "RL.PPO.num_updates_per_cycle", "1"],
        scene=dict(rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400))
    assert bench == zero
    small = dict(num_scenes=2, rows=3, cols=4, episodes_per_scene=6, rir_length=400,
                 with_frames=True)
    chip_smoke.bf16_sub_phase(torch, os.path.join(run_dir, "sub"), device="cpu",
                              opts=SMALL + ["TPU.PRECOMPUTE_RIR_RFFT", "False", "NUM_UPDATES", "2",
                                            "RL.PPO.num_updates_per_cycle", "2"], fixture=small,
                              scale=small)
    host = chip_smoke.bf16_host_eval_phase(torch, kernels, "cpu", run_dir, ckpt, device="cpu",
                                           opts=SMALL[:-2], launches=zero)
    assert host == zero
    out = capsys.readouterr().out
    assert "bf16-train mfu_info: flops_per_rollout_collect" in out and "MFU not computed" in out
    assert "[bf16-train] cycle 1 (warm)" in out and "eval of ckpt.2.pth" in out
    assert "[bench-shape] cycle 1 (warm)" in out and "bench-shape mfu_info" in out
    assert "the gather is bitwise the dense bank rounded to bfloat16" in out
    assert "bf16-sub: losses within" in out and "[bf16-host-eval] 2 episodes" in out
    shutil.rmtree(run_dir)

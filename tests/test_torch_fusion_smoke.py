"""chip_smoke.py's phase 8n (the fusion routes: fusion-train and
pairwise-train with their evals, fusion-forward, fusion-bench), small and
on the CPU (the plain kernels, so no launch counts), so that its own logic
is tested before a card runs it. The forward check runs 4 envs x 16 steps
on the trainer's 4x4 micro-scene: the default route's rollouts fit its 64
poses, so it compares the pose bank with the frames."""

import os
import shutil

import torch

import chip_smoke
from move2hear_tpu_torch.ops import kernels
from _torch_threads import cap_torch_threads

cap_torch_threads()

TINY = ["RL.PPO.hidden_size", "32", "RL.PPO.ppo_epoch", "1",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.MAX_RIR_LENGTH", "400"]
SMALL = [*TINY, "NUM_PROCESSES", "2", "RL.PPO.num_steps", "2", "NUM_UPDATES", "2",
         "RL.PPO.num_updates_per_cycle", "1", "EVAL_EPISODE_COUNT", "2",
         "TPU.DEVICE_EVAL_MIN_EPISODES", "2"]
FORWARD = [*TINY, "NUM_PROCESSES", "4", "RL.PPO.num_steps", "16"]


def test_fusion_phase_runs_on_the_cpu(tmp_path, capsys):
    zero = dict.fromkeys(kernels.launch_counts(variants=True), 0)
    run_dir = str(tmp_path / "smoke")
    counts = chip_smoke.fusion_phase(torch, kernels, "cpu", run_dir, "", 100.0, device="cpu",
                                     opts=SMALL, launches=zero, forward_opts=FORWARD)
    assert counts == {"fusion_train": zero, "pairwise_train": zero}
    stats = {}
    bench = chip_smoke.bench_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "fusion_bench"), device="cpu",
        launches=zero, label="fusion-bench", stats=stats,
        opts=["TPU.FUSED_CYCLE", "True", *SMALL[:-4]],
        scene=dict(rows=3, cols=3, num_episodes=8, near_target=True, rir_length=400))
    assert bench == zero and stats["rate"] > 0
    out = capsys.readouterr().out
    for label in ("fusion-train", "pairwise-train"):
        assert f"[{label}] cycle 1 (warm)" in out and f"{label}: TPU." in out
        assert f"[{label}] eval of ckpt.2.pth" in out
    assert "[fusion-forward]" in out and "equal actions" in out
    assert "REPORT_MFU skipped under TPU.FUSED_CYCLE" in out and "[fusion-bench] cycle 1" in out
    shutil.rmtree(run_dir)

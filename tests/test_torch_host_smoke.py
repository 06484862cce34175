"""chip_smoke.py's phases 8e-8h small on the CPU, so that their own logic
is tested before a card runs them: the file-backed fixture (2 scenes of
V = 12, RIR length 400), host training through forked ProcessVectorEnv
workers with the gate choosing the host path by itself, the host
evaluator's near-target and switch evals, and the host-vs-device parity
(both on the CPU; its tolerances as on the card)."""

import os
import shutil

import torch

import chip_smoke
from move2hear_tpu_torch.eval.switch import merge_switch_policy_checkpoint
from move2hear_tpu_torch.ops import kernels
from _torch_threads import cap_torch_threads

cap_torch_threads()

FIXTURE = dict(num_scenes=2, rows=3, cols=4, episodes_per_scene=2, rir_length=400,
               splits={"train_nearTarget": True, "test_nearTarget": True, "test_farTarget": False})
SMALL = ["RL.PPO.hidden_size", "32", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
         "TPU.MAX_RIR_LENGTH", "400"]


def test_chip_smoke_host_phases_run_on_the_cpu(tmp_path, capsys):
    run_dir = str(tmp_path)
    zero = dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    fixture_opts = chip_smoke.host_fixture_phase(os.path.join(run_dir, "layout"), FIXTURE)
    counts, ckpt = chip_smoke.host_train_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "host"), fixture_opts, device="cpu",
        opts=SMALL + ["NUM_PROCESSES", "2", "RL.PPO.num_steps", "3", "NUM_UPDATES", "4",
                      "RL.PPO.num_updates_per_cycle", "2", "RL.PPO.ppo_epoch", "2"],
        launches=zero)
    assert counts == zero and ckpt.endswith("ckpt.2.pth")
    switch = merge_switch_policy_checkpoint(ckpt, ckpt, os.path.join(run_dir, "switch.pth"))
    assert chip_smoke.host_eval_phase(
        torch, kernels, "cpu", os.path.join(run_dir, "eval"), fixture_opts, ckpt, switch,
        device="cpu", opts=SMALL + ["RL.PPO.time_thres_for_pol_switch", "2"], episodes=2,
        switch_episodes=1, launches=zero, switch_launches=zero) == [zero, zero]
    chip_smoke.host_parity_phase(torch, os.path.join(run_dir, "parity"), fixture_opts, ckpt,
                                 device="cpu", opts=SMALL)
    out = capsys.readouterr().out
    assert "1152 RIR wavs of 400 16-bit stereo samples" in out
    assert "host-train: gate host" in out and "ProcessVectorEnv workers" in out
    assert "[host-train] cycle 1 (warm)" in out and "host-train-path launches" in out
    assert "[host-eval] 2 episodes x 3 steps" in out and "[host-switch-eval] 1 episodes" in out
    assert "[host-parity]" in out and "actions equal" in out
    shutil.rmtree(tmp_path)  # the checkpoints take 0.8 GB

#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s) with its seconds:
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA sources of move2hear_tpu_torch/csrc/ (the three
     kernels and the empty kernel of the launch floor; nvcc, in parallel),
     with ptxas registers and spills; then the C++ graph walker
     (move2hear_tpu_torch/native/m2h_native.cc, host C++, not a kernel) by
     the host compiler, its command, version and seconds;
  3. kernels: each against its plain PyTorch version on the card at the
     eval path's shapes and at edge shapes (small and ragged sizes, a view
     with a storage offset; overlap_add bitwise; the masked_mix_slice16
     backward at every masked_mix_slice16 shape), and the bfloat16-mask
     variants of masked_mix_slice16 and its backward at every shape the
     bfloat16 paths launch them at and at edge shapes (a float16 mask must
     raise); then, at the paths' shapes, kernel and plain device times
     (CUDA events around CUDA-graph replays; L2-cold over input copies that
     overflow the L2, and L2-hot over one input set), the time of an empty
     kernel of the same grid in the same harness (the launch floor), the
     per-call time when issued from Python, and the least time the card's
     memory rate allows;
  4. slice: ``move2hear_tpu_torch.main --run-type eval`` with
     configs/test/nearTarget.yaml at full width (hidden 512, 64 micro-scene
     episodes, 16 envs, seeded random weights), cold then warm; the launch
     counters must read EVAL_LAUNCHES after the run;
  5. parity: a short eval on the card (TF32 off) against the same eval on
     the CPU's plain path: equal deterministic actions, STFT-L2 and SI-SDR
     within tolerance;
  6. pretrain: ``move2hear_tpu_torch.main --run-type train`` with
     configs/pretrain_passive.yaml at full width (the four passive U-Nets,
     BATCH_SIZE 64, the trainer's synthetic sources) for 3 epochs from
     seeded random weights: set-up seconds, the cold first epoch, warm
     pretrain samples/s (train samples of epochs 2-3 over their wall time),
     finite losses, both best-on-val checkpoints written, BatchNorm running
     statistics moved, launch counters equal to PRETRAIN_LAUNCHES;
  7. pretrain-eval: ``--run-type eval`` of the pretrain config on the
     checkpoint directory (PRETRAIN_EVAL_LAUNCHES);
  8. train: ``move2hear_tpu_torch.main --run-type train`` with
     configs/train/nearTarget.yaml at full width (hidden 512, 14 envs, 20
     steps, 6 updates a cycle, 4 epochs) for 2 cycles, its passive
     separators loaded from phase 6's best_ckpt_nonoverlapping_val.pth (and
     equal to it after training); set-up seconds, per-cycle seconds of
     collect, policy update and refit, warm (second-cycle) env-steps/s,
     finite losses, launch counters equal to TRAIN_LAUNCHES; then the eval
     CLI on the checkpoint it wrote;
 8a. far-train: ``--run-type train`` with configs/train/farTarget.yaml at
     full width (the same cycle as phase 8, navigation rewards, 80-step
     episodes) for 2 cycles from phase 6's separators: set-up, per-cycle
     seconds, warm far-target env-steps/s, finite losses, non-zero
     navigation rewards, launch counters equal to FAR_TRAIN_LAUNCHES;
 8b. far-eval: scripts/torch_merge_switch_ckpt.py merges 8a's checkpoint
     (navigation) with phase 8's (quality improvement), then ``--run-type
     eval`` with configs/test/farTarget.yaml (64 micro-scene episodes, 16
     envs, 100 steps, policy switch at step 80), cold then warm: set-up,
     env-steps/s, the per-episode distance fields, launch counters equal to
     FAR_EVAL_LAUNCHES;
 8c. switch-parity: a short switch-policy eval on the card (TF32 off)
     against the same eval on the CPU's plain path, as phase 5;
 8d. scale-train: ``PPOTrainer(cfg, bundle=build_scale_fixture()).train()``
     with configs/train/nearTarget.yaml at full width (phase 8's cycle) for 2
     cycles from phase 6's separators, on the 8-scene fixture (V = 300,
     16,000-sample RIRs) whose dense RIR bank (368.6 GB) does not fit: the
     gate must choose the RIR sub-banks. Slab rows and GB, rows assembled
     and uploaded and host seconds in rollout_inputs and prefetch per cycle,
     peak device memory, host memory, set-up, per-cycle seconds, warm
     env-steps/s, finite losses, launch counters equal to
     SCALE_TRAIN_LAUNCHES; the slab's gather past 2**31 elements bitwise
     equal to rows assembled anew, and its time; then scale-parity: on a
     2-scene fixture small enough for dense (TF32 off), one collect in each
     mode gives bitwise equal mixture magnitudes, the episode -> slot table
     keeps the slab gather bitwise equal to the dense one through 5 windows
     of the trainer's micro-scene, and one training cycle's parameters agree
     within TRAIN_TOL (losses) and TRAIN_DP_TOL; the scale-train run's
     build_device_scene seconds, its 8 scenes served by the C++ walker;
 8e. host-fixture: the reference's on-disk layout written into the run
     directory (env/layout.py): 14 grid scenes of V = 12 (one per env),
     graph.pkl naming networkx's Graph (written without networkx), 8,064
     16,000-sample 16-bit RIR wavs, mono wavs, observation pickles and 8
     episodes a scene of train_nearTarget, test_nearTarget and
     test_farTarget; its bytes reckoned and printed; removed after 8h;
 8f. host-train: ``--run-type train`` with configs/train/nearTarget.yaml at
     full width (phase 8's cycle) for 2 cycles from phase 6's separators on
     the fixture, RIR_MODE auto with TPU.MAX_DEVICE_BANK_BYTES below both
     bank estimates: the gate must choose the host env path, whose 14
     ProcessVectorEnv workers fork after CUDA is set up. Set-up, per-cycle
     seconds in the env step, the device step, the policy update and the
     refit, warm env-steps/s, finite losses, RIR bytes shipped a step,
     launch counters equal to HOST_TRAIN_LAUNCHES;
 8g. host-eval: ``--run-type eval`` with configs/test/nearTarget.yaml on
     8f's checkpoint over the fixture, 8 episodes (below
     DEVICE_EVAL_MIN_EPISODES: the host evaluator) with COMPUTE_EVAL_METRICS,
     then a 2-episode switch eval with configs/test/farTarget.yaml on 8b's
     merged checkpoint: env-steps/s, launch counters equal to
     HOST_EVAL_LAUNCHES and HOST_SWITCH_EVAL_LAUNCHES;
 8h. host-parity: TF32 off, deterministic actions: the host evaluator
     against the device evaluator on the 16 episodes of two fixture scenes,
     per episode equal actions, per-step STFT-L2 within HOST_PARITY_L2_TOL
     and SI-SDR within HOST_PARITY_SI_TOL above -40 dB; 8f-8h each print
     that the C++ walker served every scene from_files loaded (8f's forked
     workers inherit it);
  8i. ddppo: 2 ranks of ``--run-type train`` (configs/train/nearTarget.yaml,
     7 envs each, phase 8's cycle, gloo) as subprocesses on the one card,
     2 cycles from phase 6's separators: each rank's set-up, warm
     env-steps/s, seconds in collectives and peak device memory, the world's
     rate; both ranks' final parameters bitwise equal, each rank's launch
     counters equal to DDPPO_TRAIN_LAUNCHES. ddppo-parity (TF32 off): 2 x 7
     against 1 x 14, losses within TRAIN_TOL (relative, or absolute over
     1e-2 below it) after one update and refit and after a whole cycle in
     float32, and after one update and refit in float64 (the DDPPO tests'
     rank launcher, tests/_torch_ddppo_rank.py, M2H_TEST_FLOAT64); every
     parameter change of the float64 pair within TRAIN_DP_TOL in norm
     (phase 9's scope; the float32 pairs' are printed, a ReLU kink apart).
     ddppo-sync: one cycle with short_rollout_threshold 0.5 on the real
     TCPStore: equal executed steps and parameters on both ranks.
     ddppo-preempt: SIGUSR2 to both ranks once their handlers are set; both
     exit 0 after cycle 1 with the interrupted state saved at update 6, a
     relaunch resumes there, ends at update 12 and removes the state;
 8j. bf16-train: phase 8's train CLI with TPU.COMPUTE_DTYPE, SEP_SLAB_DTYPE
     and SEP_REFIT_DTYPE bfloat16 and REPORT_MFU, 2 cycles from phase 6's
     separators: set-up, warm env-steps/s beside phase 8's float32 rate,
     mfu_info and MFU against the card's dense bfloat16 tensor-core peak,
     finite losses, peak device memory, launch counters equal to
     BF16_TRAIN_LAUNCHES; then the eval CLI on its checkpoint;
 8k. bench-shape: bench.py's default device-mode run through the port's
     own config: 112 envs x 20 steps, 6 updates a cycle, 4 epochs, bfloat16,
     REPORT_MFU, the 4x4 micro-scene with 224 episodes and 16,000-sample
     RIRs, 2 cycles: warm env-steps/s, MFU, peak device memory, launch
     counters equal to BENCH_LAUNCHES;
 8l. bf16-sub: on the scale-parity fixture, TPU.SUB_BANK_DTYPE bfloat16:
     the gathered rows bitwise the dense bank's rounded to bfloat16, one
     cycle's losses against the float32 slab's within BF16_SUB_LOSS_REL,
     and the slab GB the gate reckons for the scale fixture at 2 bytes a
     sample (no allocation);
 8m. bf16-pretrain: 2 pretrain epochs in bfloat16 (finite losses, warm
     samples/s beside phase 6's); bf16-parity: the card's bfloat16 policy
     forward against the CPU's, under the CPU tests' discriminator; a
     2-episode host eval in bfloat16 (BF16_HOST_EVAL_LAUNCHES);
 8n. fusion routes: phase 8's train CLI with TPU.FUSED_CYCLE True, then
     with TPU.PAIRWISE_FUSION True, 2 cycles each from phase 6's
     separators: the JAX package's fusion routing (frames stored in the
     rollouts, no pose bank, no FLOP count), launch counters equal to
     TRAIN_LAUNCHES, warm env-steps/s and the warm update's seconds beside
     phase 8's rate, peak device memory, the eval CLI on each checkpoint;
     fusion-forward: TF32 off, the update's forward over the first
     collected rollout before any optimizer step, over the frames against
     over the pose bank, within FUSION_FORWARD_TOL; fusion-bench: phase
     8k's run with TPU.FUSED_CYCLE (mfu_info left None), its warm rate and
     peak memory beside phase 8k's;
 8o. graph-walker: graphs only (points.txt + graph.pkl) of 3 grid scenes of
     V = 1,024 written by env/layout.py; from_files, the far-target episode
     checks and build_device_scene on the C++ walker against the Python
     path (host seconds of each): the device tables, the episodes and
     forward_neighbor at every node and 8 orientations equal;
 9. train-parity: one PPO update and one separator refit on one injected
     full-width rollout (numpy seed) on the card (TF32 off), against the
     same on the CPU in float64: losses within 1e-4 relative, and every
     parameter tensor's change within TRAIN_DP_TOL in norm of a float64 run
     that takes the card's side of every ReLU (the CPU's float32 run
     likewise against its own such twin), while the same update with TF32
     on must read outside it; beside it the plain float64 run and the ReLU
     units where a float32 run takes another sign than float64;
 10. pretrain-parity: one pretrain train step and one eval step at full
     width and B=16 on the card (TF32 off) against the same on the CPU in
     float64: losses within 1e-4 relative; per tensor, in norm, gradients
     and BatchNorm-statistic changes within 1e-4 of a float64 run that
     takes the card's side of every ReLU, LeakyReLU and L1 kink, and
     parameter changes within 1e-4 of a float64 Adam step from the card's
     gradients; the plain float64 and the CPU's float32 runs printed
     beside it;
 11. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. Without a GPU, or without
the package beside this file, it fails at once.
"""

import contextlib
import functools
import json
import math
import os
import shlex
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2**20       # H100 SXM L2 cache
KERNEL_TOL = 1e-5           # float32 elementwise math, same formulas as plain
TRAIN_TOL = 1e-4            # relative, CUDA (TF32 off) vs CPU float64 after one update and refit
# phase 9's parameter change, in norm, of a float32 update and refit against
# float64 on the same ReLU sides: the sound runs (the card with TF32 off, the
# CPU) read up to 1.5e-4 at full width, in the bin encoder's dense layer
# whose gradient entries sit near Adam's eps; TF32 on, the control, must
# read above it.
TRAIN_DP_TOL = 3e-4
REPLACES = {
    "masked_mix_slice16": "move2hear_tpu/ops/pallas_kernels.py:85",
    "overlap_add": "move2hear_tpu/ops/pallas_kernels.py:186",
    # the analytic custom-VJP backward (jnp, not a Pallas kernel)
    "masked_mix_slice16_bwd": "move2hear_tpu/ops/pallas_kernels.py:140",
    # the same kernel and VJP for a float32 mix with a bfloat16 mask
    "masked_mix_slice16_bf16": "move2hear_tpu/ops/pallas_kernels.py:85",
    "masked_mix_slice16_bwd_bf16": "move2hear_tpu/ops/pallas_kernels.py:140",
}
# Launches of each kernel on the two paths the script drives.
# eval: 16 envs x 20 steps x 5 batches; 2 masked_mix_slice16 a step (the
# bin2mono encoder and the policy's bin encoder), one overlap_add a step.
EVAL_LAUNCHES = {"masked_mix_slice16": 160, "overlap_add": 80, "masked_mix_slice16_bwd": 0}
# train: 2 cycles x 6 updates x (20 collect steps x 2 + 2 for the bootstrap
# forward + 4 PPO epochs x 1 bin encoder over the 280 stored steps) = 552;
# the stored inputs need no gradient, so the backward never runs, and
# training computes no ISTFT.
TRAIN_LAUNCHES = {"masked_mix_slice16": 552, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# far-train: the train cycle's shape (14 envs x 20 steps, 6 updates, 4
# PPO epochs): the navigation reward adds no separator call, so 552 as train.
FAR_TRAIN_LAUNCHES = {"masked_mix_slice16": 552, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# scale-train: the train cycle's shape again; at scale the update runs the
# visual encoder per stored step (the 9,600 poses exceed the 280 steps),
# which makes no separator call: 552 as train.
SCALE_TRAIN_LAUNCHES = {"masked_mix_slice16": 552, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# bench.py's scale fixture: 8 grid scenes of V = 300 nodes, 12 episodes each,
# 16,000-sample RIRs, frames
SCALE_FIXTURE = dict(num_scenes=8, rows=15, cols=20, episodes_per_scene=12, rir_length=16000,
                     with_frames=True)
# scale-parity: 2 scenes of V = 12, small enough for the dense bank (73.7 MB)
SCALE_PARITY_FIXTURE = dict(num_scenes=2, rows=3, cols=4, episodes_per_scene=6,
                            rir_length=16000, with_frames=True)
# far-eval: 16 envs x 100 steps x 4 batches (64 episodes); either policy of
# the switch makes the eval's 2 masked_mix_slice16 and 1 overlap_add a step.
FAR_EVAL_LAUNCHES = {"masked_mix_slice16": 800, "overlap_add": 400, "masked_mix_slice16_bwd": 0}
# phases 8e-8h: the file-backed fixture, 14 scenes (one per env: the scene
# split asserts at least as many scenes as envs) of V = 12, 8 episodes of
# each split a scene, 16,000-sample RIRs
HOST_FIXTURE = dict(num_scenes=14, rows=3, cols=4, episodes_per_scene=8, rir_length=16000,
                    splits={"train_nearTarget": True, "test_nearTarget": True,
                            "test_farTarget": False})
# host-train: 2 cycles of 6 updates x 20 steps at 14 envs: the first
# forward (2, B=14) + 240 env steps x 2 (the bin2mono encoder and the
# policy's bin encoder, B=14) + 12 updates x 4 PPO epochs x 1 bin encoder
# (B=280) + 2 cycles x 6 refits x 6 render chunks of 20 rows x 1 bin2mono
# encoder (B=280) = 2 + 480 + 48 + 72 = 602; no ISTFT, no backward.
HOST_TRAIN_LAUNCHES = {"masked_mix_slice16": 602, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# host-eval: 8 episodes x 20 steps x 2 (B=1); the SI-SDR's ISTFTs are numpy.
HOST_EVAL_LAUNCHES = {"masked_mix_slice16": 320, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# host switch eval: 2 episodes x 100 steps x 2 (B=1), either policy.
HOST_SWITCH_EVAL_LAUNCHES = {"masked_mix_slice16": 400, "overlap_add": 0,
                             "masked_mix_slice16_bwd": 0}
# phase 8o: graphs only (points.txt + graph.pkl, no RIRs) of 3 grid scenes
# of V = 1,024 (Matterport's graphs hold 100-1,000 nodes a scene), and 8
# far-target episodes a scene, whose start check looks up a BFS row from
# every node
GRAPH_FIXTURE = dict(num_scenes=3, rows=32, cols=32, episodes=8)
# pretrain: 3 epochs x (256 // 64 = 4 train steps + 1 val and 1
# nonoverlapping-val batch of 64) = 18, one in the bin2mono encoder each;
# its masks enter detached (the JAX package's stop_gradient), and the
# mixture is rendered data, so no gradient reaches the kernel's inputs and
# the backward never runs; no ISTFT.
PRETRAIN_EPOCHS = 3
PRETRAIN_LAUNCHES = {"masked_mix_slice16": 18, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# pretrain-eval: its 2 best checkpoints x 2 validation batches of 64.
PRETRAIN_EVAL_LAUNCHES = {"masked_mix_slice16": 4, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
# phase 8i: 2 ranks x 7 envs on the one card over gloo, phase 8's cycle;
# each rank launches phase 8's count: 2 cycles x 6 updates x (20 collect
# steps x 2 at B=7 + 2 for the bootstrap forward + 4 PPO epochs x 1 bin
# encoder at B=140) = 552.
DDPPO_TRAIN_LAUNCHES = {"masked_mix_slice16": 552, "overlap_add": 0, "masked_mix_slice16_bwd": 0}
DDPPO_RANKS = 2
DDPPO_OPTS = ["NUM_PROCESSES", "7", "RL.PPO.ddppo_distrib_backend", "GLOO"]
# Phases 8j-8m, TPU.COMPUTE_DTYPE bfloat16: the separators hand the kernel
# bfloat16 masks, so every masked_mix_slice16 launch of these paths is the
# bfloat16-mask variant.
BF16_OPTS = ["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEP_SLAB_DTYPE", "bfloat16",
             "TPU.SEP_REFIT_DTYPE", "bfloat16", "TPU.REPORT_MFU", "True"]


def _bf16_launches(n):
    return {"masked_mix_slice16": 0, "overlap_add": 0, "masked_mix_slice16_bwd": 0,
            "masked_mix_slice16_bf16": n, "masked_mix_slice16_bwd_bf16": 0}


# bf16-train: phase 8's cycle, 552 as train (B=14 collect, B=280 PPO epoch).
BF16_TRAIN_LAUNCHES = _bf16_launches(552)
# bench-shape: 2 cycles x 6 updates x (20 collect steps x 2 + 2 for the
# bootstrap forward + 4 PPO epochs x 1) = 552, at B=112 in the collect and
# B=2240 in the PPO epochs.
BENCH_LAUNCHES = _bf16_launches(552)
# bench.py:117-147's overrides (device mode) and its 4x4 micro-scene
# (bench.py:158-161 at 112 envs: max(64, 2 x 112) episodes)
BENCH_OPTS = [
    "NUM_PROCESSES", "112", "NUM_UPDATES", "12", "CHECKPOINT_INTERVAL", "100000",
    "LOG_INTERVAL", "100000", "RL.PPO.num_steps", "20", "RL.PPO.num_updates_per_cycle", "6",
    "RL.PPO.ppo_epoch", "4", "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
    "RL.PPO.sep_reward_weight", "1.0", "RL.PPO.nav_reward_weight", "0.0",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "20",
    "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", "TPU.STATS_FETCH_INTERVAL", "2",
    "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.REPORT_MFU", "True",
]
BENCH_SCENE = dict(rows=4, cols=4, num_episodes=224, near_target=True, rir_length=16000)
# Phase 8n: the JAX package's fusion knobs on phase 8's train CLI, each with
# phase 8's 552 launches (the stored frames change the update's visual
# input, not its separator calls), and FUSED_CYCLE at the bench shape with
# phase 8k's; (knob, label) of each route.
FUSION_ROUTES = (("FUSED_CYCLE", "fusion-train"), ("PAIRWISE_FUSION", "pairwise-train"))
# the update's forward over the stored frames against over the pose bank,
# relative to the largest output: the same float32 convolutions over other
# batches (280 frames, 64 poses), TF32 off
FUSION_FORWARD_TOL = 1e-5
# bf16-pretrain: 2 epochs x (4 train steps + 2 validation batches of 64).
BF16_PRETRAIN_EPOCHS = 2
BF16_PRETRAIN_LAUNCHES = _bf16_launches(12)
# bf16 host eval: 2 episodes x 20 steps x 2 (B=1).
BF16_HOST_EVAL_LAUNCHES = _bf16_launches(80)
# bf16-sub: one cycle's losses on the bfloat16 slab against the float32
# slab's (tests/test_torch_bf16_knobs.py holds the CPU to the same bound):
# the RIRs rounded to bfloat16 move each render by about 2**-9 relative.
BF16_SUB_LOSS_REL = 2e-2
# Dense bfloat16 tensor-core peak by the name nvidia-smi gives, and its
# source (NVIDIA H100 Tensor Core GPU data sheet: BF16 1,979 TFLOPS with
# sparsity for the SXM5 part, 1,513 for PCIe, 1,671 for NVL; dense is half)
BF16_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": (989e12, "H100 SXM5 data sheet, 1,979 TFLOP/s sparse / 2"),
    "NVIDIA H100 PCIe": (756e12, "H100 PCIe data sheet, 1,513 TFLOP/s sparse / 2"),
    "NVIDIA H100 NVL": (835e12, "H100 NVL data sheet, 1,671 TFLOP/s sparse / 2"),
}
# the bf16-parity discriminator, tests/test_torch_bf16_models.py's: the card
# at least BF16_RATIO times closer to the CPU's bfloat16 than that is to
# the CPU's float32 (mean abs error), the largest error within
# BF16_MAX_ULPS bfloat16 ulps of the largest output
BF16_RATIO, BF16_MAX_ULPS = 2.0, 4
# Shapes each kernel is held to on the card. The first is the eval path's
# (one launch per separator call at 16 envs; the step's five ISTFTs of 16
# envs in one trimmed overlap-add); masked_mix_slice16's "train" is the PPO
# epoch's (20 steps x 14 envs flattened), "pretrain" a pretrain batch. The
# backward is held at every
# masked_mix_slice16 shape. masked_mix_slice16: (B, F, T, C, storage
# offset in floats); overlap_add: (B, n_frames, n_fft, hop, start, length or
# None for the whole signal, storage offset in floats).
MM_CASES = {
    "path": (16, 512, 32, 2, 0),
    "train": (280, 512, 32, 2, 0),
    "pretrain": (64, 512, 32, 2, 0),
    "collect": (14, 512, 32, 2, 0),
    "ddppo-collect": (7, 512, 32, 2, 0),
    "ddppo-train": (140, 512, 32, 2, 0),
    "B=1": (1, 512, 32, 2, 0),
    "C=1": (2, 512, 32, 1, 0),
    "C=3": (2, 64, 8, 3, 0),
    "F=16": (2, 16, 32, 2, 0),
    "T=1": (2, 512, 1, 2, 0),
    "T=6": (2, 512, 6, 2, 0),
    "T=33": (2, 512, 33, 2, 0),
    "offset1": (4, 512, 32, 2, 1),
}
# The bfloat16-mask variant at every shape the bfloat16 paths launch it at
# (collect B=14, PPO epoch B=280, pretrain B=64, host evaluator B=1, the
# bench shape's collect B=112 and PPO epoch B=2240) and edge shapes; the
# backward at all of them. The mask's storage offset counts bfloat16
# elements (offset 1: not on an 8-byte boundary, the scalar kernel).
MM_BF16_CASES = {
    "collect": (14, 512, 32, 2, 0),
    "train": (280, 512, 32, 2, 0),
    "pretrain": (64, 512, 32, 2, 0),
    "B=1": (1, 512, 32, 2, 0),
    "bench-collect": (112, 512, 32, 2, 0),
    "bench-train": (2240, 512, 32, 2, 0),
    "C=1": (2, 512, 32, 1, 0),
    "T=6": (2, 512, 6, 2, 0),
    "T=33": (2, 512, 33, 2, 0),
    "offset1": (4, 512, 32, 2, 1),
}
OLA_CASES = {
    "path": (80, 32, 1023, 512, 511, 16000, 0),
    "B=16-whole": (16, 32, 1023, 512, 0, None, 0),
    "B=1": (1, 32, 1023, 512, 511, 16000, 0),
    "one-frame": (2, 1, 1023, 512, 0, None, 0),
    "hop200": (2, 10, 1023, 200, 100, 1901, 0),
    "odd-out-len": (2, 5, 1023, 512, 0, None, 0),
    "length-16001": (3, 32, 1023, 512, 511, 16001, 0),
    "hop3": (2, 9, 8, 3, 5, 23, 0),
    "offset1": (16, 32, 1023, 512, 511, 16000, 1),
}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, t0: float, detail: str):
    print(f"[{name}] {detail} ({time.perf_counter() - t0:.3f} s)", flush=True)


def eager_ms(fn, n: int = 200) -> float:
    """Per-call time of `fn` issued from Python: host launch cost included."""
    import torch

    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, inputs, n: int = 100, reps: int = 5) -> float:
    """Device time per call of ``fn(*args)``: `n` calls captured in one CUDA
    graph and replayed, so host launch cost drops out. The calls rotate over
    `inputs`, copies that together overflow the L2 cache, and keep their
    outputs, so each call reads and writes HBM as `bound_ms` assumes."""
    import torch

    fn(*inputs[0])
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(n):
            outs.append(fn(*inputs[i % len(inputs)]))
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def l2_cold_copies(*tensors):
    """Copies of `tensors`, enough that together they take twice the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors) for _ in range(math.ceil(2 * L2_BYTES / nbytes))]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def walker_build():
    """Build the C++ graph walker (move2hear_tpu_torch/native/) from the
    checkout's source with the host compiler. Returns (compiler command,
    its version line, build seconds)."""
    from move2hear_tpu_torch.native import binding

    lib = binding.library_path()
    if os.path.exists(lib):
        os.remove(lib)  # always build from the checkout's source
    _, secs = binding.build()
    cxx = binding.compiler()
    version = subprocess.run([*cxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    return shlex.join(cxx), (version or ["version unknown"])[0], secs


@contextlib.contextmanager
def walker_watch():
    """While the block runs, record every scene ``GraphScene.from_files``
    loads and every ``build_device_scene`` call: its seconds and, per
    scene, V and whether the C++ walker served it."""
    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.env.scene import GraphScene

    seen = {"loaded": [], "built": []}
    load, build = GraphScene.__dict__["from_files"], de.build_device_scene

    def from_files(cls, *args, **kwargs):
        scene = load.__func__(cls, *args, **kwargs)
        seen["loaded"].append(scene)
        return scene

    def build_device_scene(scenes, device):
        t0 = time.perf_counter()
        out = build(scenes, device)
        seen["built"].append((time.perf_counter() - t0, [
            (s.num_nodes, s._native is not None) for s in de._scene_list(scenes)]))
        return out

    GraphScene.from_files, de.build_device_scene = classmethod(from_files), build_device_scene
    try:
        yield seen
    finally:
        GraphScene.from_files, de.build_device_scene = load, build


def report_walker(label: str, seen, card: str):
    """Print which scenes of a walker_watch the C++ walker served; fail if
    a scene from_files loaded, or one of NATIVE_MIN_NODES or more that
    build_device_scene stacked, went without it."""
    from move2hear_tpu_torch.env.device_env import NATIVE_MIN_NODES

    loaded = seen["loaded"]
    if any(s._native is None for s in loaded):
        fail(f"{label}: a scene from_files loaded moves without the C++ walker")
    parts = [f"{len(loaded)} of {len(loaded)} scenes from_files loaded"] if loaded else []
    for secs, scenes in seen["built"]:
        if any(v >= NATIVE_MIN_NODES and not native for v, native in scenes):
            fail(f"{label}: build_device_scene took the Python BFS for a scene of "
                 f"{NATIVE_MIN_NODES} nodes or more: {scenes}")
        served = sum(native for _, native in scenes)
        parts.append(f"build_device_scene {served} of {len(scenes)} scenes (V = "
                     f"{sorted({v for v, _ in scenes})}) in {secs:.3f} s")
    print(f"{label}: the C++ graph walker served " + ("; ".join(parts) or "no scene")
          + f" (host seconds, {card})", flush=True)


def on_card(torch, array, offset: int):
    """`array` as a contiguous float32 CUDA tensor whose data starts `offset`
    floats into its storage (offset 1: not on a 16-byte boundary)."""
    buf = torch.empty(array.size + offset, dtype=torch.float32, device="cuda")
    out = buf[offset:].view(array.shape)
    out.copy_(torch.from_numpy(array.astype("float32")))
    return out


def mm_inputs(torch, case, seed=SEED):
    """(mix, mask) of a MM_CASES shape, from a numpy seed."""
    import numpy as np

    b, f, t, c, offset = case
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((b, f, t, c)))
    mask = rng.uniform(-0.5, 1.5, (b, f, t, c))
    return on_card(torch, mix, offset), on_card(torch, mask, offset)


def mm_bwd_inputs(torch, case, seed=SEED):
    """(g, mix, mask) of a MM_CASES shape: the NCHW cotangent and the
    forward's inputs, from a numpy seed."""
    import numpy as np

    b, f, t, c, offset = case
    mix, mask = mm_inputs(torch, case, seed)
    g = np.random.default_rng(seed + 1).standard_normal((b, 16 * c, f // 16, t))
    return (on_card(torch, g, offset), mix, mask)


def mm_bf16_inputs(torch, case, seed=SEED):
    """(mix, mask) of a MM_BF16_CASES shape: mm_inputs's mix, and its mask
    rounded to a bfloat16 tensor whose data starts `offset` bfloat16
    elements into its storage."""
    b, f, t, c, offset = case
    mix, mask32 = mm_inputs(torch, (b, f, t, c, offset))
    buf = torch.empty(mask32.numel() + offset, dtype=torch.bfloat16, device="cuda")
    mask = buf[offset:].view(mask32.shape)
    mask.copy_(mask32)
    return mix, mask


def mm_bf16_bwd_inputs(torch, case, seed=SEED):
    """(g, mix, mask) of a MM_BF16_CASES shape."""
    g, _, _ = mm_bwd_inputs(torch, case, seed)
    return (g, *mm_bf16_inputs(torch, case, seed))


def ola_inputs(torch, case, seed=SEED):
    """(frames,) of an OLA_CASES shape, from a numpy seed."""
    import numpy as np

    b, n_frames, n_fft, _, _, _, offset = case
    frames = np.random.default_rng(seed).standard_normal((b, n_frames, n_fft))
    return (on_card(torch, frames, offset),)


def ola_call(kernels, case, plain=False):
    """overlap_add (or its plain version) at an OLA_CASES shape."""
    b, n_frames, n_fft, hop, start, length, _ = case
    if not plain:
        return functools.partial(kernels.overlap_add, n_fft=n_fft, hop=hop, start=start, length=length)
    win, inv_env = kernels.ola_tables(n_fft, hop, n_frames, "cuda")
    return functools.partial(kernels.overlap_add_plain, win=win, inv_env=inv_env, hop=hop,
                             start=start, length=length)


def ola_work(case):
    """(bytes, float operations, blocks, threads) of an overlap_add call:
    the frame samples the kept output needs, the window and envelope once,
    the output once; the grid as csrc/overlap_add.cu launches it."""
    b, n_frames, n_fft, hop, start, length, _ = case
    if length is None:
        length = n_fft + hop * (n_frames - 1) - start
    needed = sum(max(0, min(i * hop + n_fft, start + length) - max(i * hop, start))
                 for i in range(n_frames))
    nbytes = (b * needed + n_fft + length + b * length) * 4
    blocks = -(-((length + 6) // 4) // 128) * b
    return nbytes, 2 * b * needed + b * length, blocks, 128


def mm_work(case):
    """(bytes, float operations, blocks, threads) of a masked_mix_slice16
    call: two inputs read, one output written, expm1, mul, max and log1p per
    element; the grid as csrc/masked_mix_slice16.cu launches it."""
    b, f, t, c, offset = case
    n = b * f * t * c
    c2 = c == 2 and t % 2 == 0 and offset == 0  # the float4 kernel
    tx = min(t // 2 if c2 else t, 32)
    ty = 256 // tx
    return 3 * n * 4, 4 * n, -(-(f // 16) // ty) * 16 * b, tx * ty


def mm_bwd_work(case):
    """(bytes, float operations, blocks, threads) of a masked_mix_slice16_bwd
    call: three inputs read, two outputs written; expm1, exp, a compare, an
    add, a divide and four multiplies per element; the forward's grid."""
    n = math.prod(case[:4])
    _, _, blocks, threads = mm_work(case)
    return 5 * n * 4, 10 * n, blocks, threads


def mm_bf16_work(case):
    """mm_work for a bfloat16 mask: 4 + 2 bytes read and 4 written an
    element (10, against the float32 pair's 12); the same grid (the vector
    kernel needs the mask on an 8-byte boundary, which offset 0 gives)."""
    n = math.prod(case[:4])
    _, nops, blocks, threads = mm_work(case)
    return 10 * n, nops, blocks, threads


def mm_bf16_bwd_work(case):
    """mm_bwd_work for a bfloat16 mask: g, mix and the mask read (4 + 4 +
    2 bytes), dmix and a float32 dmask written (8)."""
    n = math.prod(case[:4])
    _, nops, blocks, threads = mm_bwd_work(case)
    return 18 * n, nops, blocks, threads


def path_counts(kernels, expected):
    """The launch counts of the kernels `expected` names, read just after a
    path's run; any other kernel that launched (a bfloat16-mask variant on
    a float32 path, or the reverse) fails the phase."""
    counts = kernels.launch_counts(variants=True)
    stray = {k: v for k, v in counts.items() if k not in expected and v}
    if stray:
        fail(f"kernels launched that the path does not run: {stray}")
    return {k: counts[k] for k in expected}


def check_phase(torch, kernels):
    """Phase 3a: every kernel against its plain version at every case shape.
    Returns {kernel: max abs error at the path shape}."""
    errs = {}
    for label, case in MM_CASES.items():
        args = mm_inputs(torch, case)
        err = float((kernels.masked_mix_slice16(*args) - kernels.masked_mix_slice16_plain(*args)).abs().max())
        torch.cuda.synchronize()
        if not err <= KERNEL_TOL:
            fail(f"masked_mix_slice16 {label} {case}: max abs error {err} > {KERNEL_TOL}")
        errs.setdefault("masked_mix_slice16", err)
        g, mix, mask = mm_bwd_inputs(torch, case)
        (dmix, dmask), (pmix, pmask) = (kernels.masked_mix_slice16_bwd(g, mix, mask),
                                        kernels.masked_mix_slice16_bwd_plain(g, mix, mask))
        bwd_err = max(float((dmix - pmix).abs().max()), float((dmask - pmask).abs().max()))
        torch.cuda.synchronize()
        if not bwd_err <= KERNEL_TOL:
            fail(f"masked_mix_slice16_bwd {label} {case}: max abs error {bwd_err} > {KERNEL_TOL}")
        errs.setdefault("masked_mix_slice16_bwd", bwd_err)
        print(f"check masked_mix_slice16 {label} {case[:4]} offset {case[4]}: max abs err {err:.3e}; "
              f"backward {bwd_err:.3e}", flush=True)
    for label, case in OLA_CASES.items():
        args = ola_inputs(torch, case)
        out, ref = ola_call(kernels, case)(*args), ola_call(kernels, case, plain=True)(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.equal(out, ref):
            err = float((out - ref).abs().max()) if out.shape == ref.shape else math.inf
            fail(f"overlap_add {label} {case}: not bitwise equal to the plain version (max abs err {err})")
        errs.setdefault("overlap_add", 0.0)
        print(f"check overlap_add {label} {case[:6]} offset {case[6]}: bitwise equal", flush=True)
    for label, case in MM_BF16_CASES.items():
        mix, mask = mm_bf16_inputs(torch, case)
        before = kernels.masked_mix_slice16_bf16.launches
        out = kernels.masked_mix_slice16(mix, mask)
        if kernels.masked_mix_slice16_bf16.launches != before + 1 or out.dtype != torch.float32:
            fail(f"masked_mix_slice16_bf16 {label}: no variant launch or a {out.dtype} output")
        err = float((out - kernels.masked_mix_slice16_plain(mix, mask)).abs().max())
        g, _, _ = mm_bf16_bwd_inputs(torch, case)
        (dmix, dmask), (pmix, pmask) = (kernels.masked_mix_slice16_bwd(g, mix, mask),
                                        kernels.masked_mix_slice16_bwd_plain(g, mix, mask))
        bwd_err = max(float((dmix - pmix).abs().max()), float((dmask - pmask).abs().max()))
        torch.cuda.synchronize()
        if not (err <= KERNEL_TOL and bwd_err <= KERNEL_TOL and dmask.dtype == torch.float32):
            fail(f"masked_mix_slice16 bf16-mask {label} {case}: max abs error {err}, backward "
                 f"{bwd_err} (tol {KERNEL_TOL}), dmask {dmask.dtype}")
        errs.setdefault("masked_mix_slice16_bf16", err)
        errs.setdefault("masked_mix_slice16_bwd_bf16", bwd_err)
        print(f"check masked_mix_slice16 bf16 mask {label} {case[:4]} offset {case[4]}: max abs "
              f"err {err:.3e}; backward {bwd_err:.3e}", flush=True)
    mix, mask = mm_bf16_inputs(torch, MM_BF16_CASES["B=1"])
    for pair in ((mix, mask.to(torch.float16)), (mix.to(torch.bfloat16), mask)):
        try:
            kernels.masked_mix_slice16(*pair)
        except TypeError as e:
            print(f"check masked_mix_slice16 refuses the pair: {e}", flush=True)
        else:
            fail(f"masked_mix_slice16 took a {pair[0].dtype} mix with a {pair[1].dtype} mask")
    return errs


# the shape of each kernel's row in the JSON line: the float32 forwards at
# the eval path's, the backward and the bfloat16-mask variants at the
# training shape (the PPO epoch's B=280)
JSON_SHAPE = {"masked_mix_slice16": "path", "overlap_add": "path",
              "masked_mix_slice16_bwd": "train", "masked_mix_slice16_bf16": "train",
              "masked_mix_slice16_bwd_bf16": "train"}


def time_phase(torch, kernels, errs):
    """Phase 3b: times and bounds at the paths' shapes (and overlap_add at
    the whole-signal B=16 shape it was first timed at). Returns the JSON
    rows, one per kernel at its JSON_SHAPE; the other shapes are printed."""
    from move2hear_tpu_torch.ops import build

    empty = build_empty()
    timed = [  # name, label, kernel, plain, inputs, work
        ("masked_mix_slice16", "path", kernels.masked_mix_slice16, kernels.masked_mix_slice16_plain,
         mm_inputs(torch, MM_CASES["path"]), mm_work(MM_CASES["path"])),
        ("masked_mix_slice16", "train", kernels.masked_mix_slice16,
         kernels.masked_mix_slice16_plain, mm_inputs(torch, MM_CASES["train"]),
         mm_work(MM_CASES["train"])),
        ("masked_mix_slice16", "pretrain", kernels.masked_mix_slice16,
         kernels.masked_mix_slice16_plain, mm_inputs(torch, MM_CASES["pretrain"]),
         mm_work(MM_CASES["pretrain"])),
        ("masked_mix_slice16", "collect", kernels.masked_mix_slice16,
         kernels.masked_mix_slice16_plain, mm_inputs(torch, MM_CASES["collect"]),
         mm_work(MM_CASES["collect"])),
        ("masked_mix_slice16", "ddppo-collect", kernels.masked_mix_slice16,
         kernels.masked_mix_slice16_plain, mm_inputs(torch, MM_CASES["ddppo-collect"]),
         mm_work(MM_CASES["ddppo-collect"])),
        ("masked_mix_slice16", "ddppo-train", kernels.masked_mix_slice16,
         kernels.masked_mix_slice16_plain, mm_inputs(torch, MM_CASES["ddppo-train"]),
         mm_work(MM_CASES["ddppo-train"])),
        ("masked_mix_slice16", "B=1", kernels.masked_mix_slice16,
         kernels.masked_mix_slice16_plain, mm_inputs(torch, MM_CASES["B=1"]),
         mm_work(MM_CASES["B=1"])),
        ("masked_mix_slice16_bwd", "train", kernels.masked_mix_slice16_bwd,
         kernels.masked_mix_slice16_bwd_plain, mm_bwd_inputs(torch, MM_CASES["train"]),
         mm_bwd_work(MM_CASES["train"])),
        ("masked_mix_slice16_bwd", "path", kernels.masked_mix_slice16_bwd,
         kernels.masked_mix_slice16_bwd_plain, mm_bwd_inputs(torch, MM_CASES["path"]),
         mm_bwd_work(MM_CASES["path"])),
        *[("masked_mix_slice16_bf16", label, kernels.masked_mix_slice16_bf16,
           kernels.masked_mix_slice16_plain, mm_bf16_inputs(torch, MM_BF16_CASES[label]),
           mm_bf16_work(MM_BF16_CASES[label]))
          for label in ("collect", "train", "pretrain", "B=1", "bench-collect", "bench-train")],
        ("masked_mix_slice16_bwd_bf16", "train", kernels.masked_mix_slice16_bwd_bf16,
         kernels.masked_mix_slice16_bwd_plain, mm_bf16_bwd_inputs(torch, MM_BF16_CASES["train"]),
         mm_bf16_bwd_work(MM_BF16_CASES["train"])),
        ("overlap_add", "path", ola_call(kernels, OLA_CASES["path"]),
         ola_call(kernels, OLA_CASES["path"], plain=True),
         ola_inputs(torch, OLA_CASES["path"]), ola_work(OLA_CASES["path"])),
        ("overlap_add", "B=16-whole", ola_call(kernels, OLA_CASES["B=16-whole"]),
         ola_call(kernels, OLA_CASES["B=16-whole"], plain=True),
         ola_inputs(torch, OLA_CASES["B=16-whole"]), ola_work(OLA_CASES["B=16-whole"])),
    ]
    rows = {}
    for name, label, kern, plain, args, (nbytes, nops, blocks, threads) in timed:
        t0 = time.perf_counter()
        copies = l2_cold_copies(*args)
        # a graph keeps every call's output: 20 calls of the bench shape's
        # PPO epoch (0.29 GB out each) where the others take 100
        n = 100 if nbytes < 2e8 else 20
        ms, plain_ms = device_ms(kern, copies, n), device_ms(plain, copies, n)
        hot_ms = device_ms(kern, [args], n)
        floor_ms = device_ms(lambda: empty(blocks, threads), [()])
        eager, eager_plain = eager_ms(lambda: kern(*args)), eager_ms(lambda: plain(*args))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        if label == JSON_SHAPE[name]:
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"move2hear_tpu_torch/csrc/{build.VARIANT_OF.get(name, name)}.cu",
                "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                # no one PyTorch call computes either function
                "library_ms": None,
            }
        extra = ""
        if name == "overlap_add" and label == "B=16-whole":
            # F.fold sums the frames: the overlap-add without window and envelope
            out_len = 1023 + 512 * 31
            fold_ms = device_ms(
                lambda fr: torch.nn.functional.fold(
                    fr.transpose(1, 2), (1, out_len), (1, 1023), stride=(1, 512)),
                copies,
            )
            extra = f"; F.fold sum alone (no window, no envelope) {fold_ms * 1e3:.2f} us"
        phase("kernel", t0, (
            f"{name} {label} {tuple(args[0].shape)}: L2-cold {ms * 1e3:.2f} us "
            f"({len(copies)} input copies), L2-hot {hot_ms * 1e3:.2f} us, plain L2-cold "
            f"{plain_ms * 1e3:.2f} us, empty kernel of the same grid ({blocks} x {threads}) "
            f"{floor_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}, {nbytes} B), "
            f"{100 * bound / ms:.1f}% of the bound{extra}; issued from Python "
            f"{eager * 1e3:.2f} us, plain {eager_plain * 1e3:.2f} us per call"
        ))
    return rows


def build_empty():
    """The launch floor: a callable launching csrc/empty.cu's empty kernel
    with (blocks, threads) on the current stream."""
    import torch

    from move2hear_tpu_torch.ops import build

    fn = build.load("empty").empty_launch

    def launch(blocks, threads):
        rc = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"empty kernel: launch failed, CUDA error {rc}")

    return launch


def run_eval(torch, kernels, run_dir, runs: int):
    """The eval CLI at full width `runs` times in one process, each with the
    launch counters set to 0 just before it. Returns [(launch counts, timing
    dict, wall s, aggregates)] and the stats path the runs wrote."""
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.main import main as port_main
    from move2hear_tpu_torch.models import Move2HearPolicy
    from move2hear_tpu_torch.utils.checkpoint import save_checkpoint

    exp = os.path.join(REPO, "configs", "test", "nearTarget.yaml")
    cfg = get_config(exp, [], run_dir, "eval")
    torch.manual_seed(SEED)
    policy = Move2HearPolicy(
        num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS), hidden_size=cfg.RL.PPO.hidden_size,
        extra_rgb=cfg.EXTRA_RGB, extra_depth=cfg.EXTRA_DEPTH, use_ddppo=cfg.RL.PPO.use_ddppo,
    )
    ckpt = os.path.join(run_dir, "ckpt.0.pt")
    save_checkpoint(ckpt, {"state_dict": policy.state_dict(), "config": cfg.to_dict()})
    argv = ["--run-type", "eval", "--exp-config", exp, "--model-dir", run_dir,
            "EVAL_CKPT_PATH_DIR", ckpt]
    results = []
    for _ in range(runs):
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        trainer = port_main(argv)
        torch.cuda.synchronize()
        counts = path_counts(kernels, EVAL_LAUNCHES)
        results.append((counts, trainer.last_eval[1], time.perf_counter() - t0, trainer.last_eval[0]))
    return results, os.path.join(run_dir, f"{cfg.EVAL.SPLIT}_stats_ckpt_0_{cfg.SEED}.json")


def slice_phase(torch, kernels, card, run_dir):
    """Phase 4: the eval CLI at full width, cold then warm."""
    t0 = time.perf_counter()
    results, stats = run_eval(torch, kernels, run_dir, 2)
    for run, (counts, tm, wall, agg) in zip(("cold", "warm"), results):
        if counts != EVAL_LAUNCHES:
            fail(f"eval-path kernel launches {counts}, expected {EVAL_LAUNCHES}")
        phase("slice", t0, (
            f"run {run}: {tm['episodes'] / tm['loop_s']:.3f} episodes/s, "
            f"{tm['env_steps'] / tm['loop_s']:.1f} env-steps/s over the episode loop "
            f"({tm['loop_s']:.3f} s), set-up {tm['setup_s']:.3f} s, "
            f"end to end {tm['env_steps'] / wall:.1f} env-steps/s ({card})"
        ))
    for k in ("mono_l2_last", "mem_l2_last", "mono_si_sdr_last", "monoFromMem_si_sdr_last"):
        if k not in agg or not all(math.isfinite(v) for v in agg[k].values()):
            fail(f"aggregate {k} missing or not finite: {agg.get(k)}")
    if not os.path.exists(stats) or tm["episodes"] != 64:
        fail(f"eval wrote no {stats} or played {tm['episodes']} episodes, not 64")
    print("slice aggregates: " + ", ".join(
        f"{k} {agg[k]['mean']:.6f}" for k in
        ("mono_l2_last", "mem_l2_last", "bin_l2_all", "mono_si_sdr_last", "monoFromMem_si_sdr_last")
    ), flush=True)
    print(f"eval-path launches: {counts}", flush=True)
    return counts


PRETRAIN_EXP = os.path.join(REPO, "configs", "pretrain_passive.yaml")


def pretrain_phase(torch, kernels, card, run_dir, device="cuda", opts=(),
                   launches=PRETRAIN_LAUNCHES, label="pretrain", epochs=PRETRAIN_EPOCHS,
                   stats=None):
    """Phase 6 (and 8m's bf16-pretrain): the pretrain CLI at full width for
    `epochs` epochs, with the launch counters set to 0 just before it and
    read just after. Returns (the pretrain path's launch counts, its
    checkpoint folder); `stats`, if given, receives the warm samples/s.
    (`device`, `opts` and `launches` let a rehearsal run it small on the
    CPU.)"""
    import numpy as np

    from move2hear_tpu_torch.main import main as port_main
    from move2hear_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    trainer = port_main(["--run-type", "train", "--exp-config", PRETRAIN_EXP, "--model-dir",
                         run_dir, "--device", device, "Pretrain.Passive.NUM_EPOCHS",
                         str(epochs), *opts])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    wall = time.perf_counter() - t0
    if counts != launches:
        fail(f"{label}-path kernel launches {counts}, expected {launches}")
    n_epochs, epochs = epochs, trainer.epoch_log
    if len(epochs) != n_epochs:
        fail(f"{label} ran {len(epochs)} epochs, expected {n_epochs}")
    for i, (e, h) in enumerate(zip(epochs, trainer._val_history)):
        if not np.isfinite([*h["train"], *h["val"], *h["nonoverlapping_val"]]).all():
            fail(f"{label} epoch {i}: losses not finite: {h}")
        phase(label, t0, (
            f"epoch {i} ({'cold' if i == 0 else 'warm'}): {e['train_samples']} train samples and "
            f"2 val batches in {e['seconds']:.3f} s; train bin {h['train'][0]:.6f} mono "
            f"{h['train'][1]:.6f}, val mono {h['val'][1]:.6f}, nonoverlapping val mono "
            f"{h['nonoverlapping_val'][1]:.6f} ({card})"
        ))
    warm = epochs[1:]
    rate = sum(e["train_samples"] for e in warm) / sum(e["seconds"] for e in warm)
    if stats is not None:
        stats["warm_rate"] = rate
    print(f"{label}: set-up {trainer.setup_s:.3f} s, cold first epoch {epochs[0]['seconds']:.3f} s, "
          f"warm pretrain {rate:.1f} samples/s (epochs 2-{len(epochs)}; {card}), end to end "
          f"{wall:.3f} s; {label}-path launches: {counts}", flush=True)
    folder = trainer.config.CHECKPOINT_FOLDER
    for name in ("best_ckpt_val.pth", "best_ckpt_nonoverlapping_val.pth"):
        path = os.path.join(folder, name)
        if not os.path.exists(path):
            fail(f"pretrain wrote {sorted(os.listdir(folder))}, not {name}")
        ckpt = load_checkpoint(path)
        for net in ("binSep_enc", "binSep_dec", "bin2mono_enc", "bin2mono_dec"):
            stats = [(k, v) for k, v in ckpt["state_dict"].items()
                     if k.startswith(net + ".") and "running_" in k]
            moved = [bool((v != (1.0 if k.endswith("var") else 0.0)).any()) for k, v in stats]
            if not stats or not all(moved):
                fail(f"pretrain {name}: BatchNorm statistics of {net} did not all move")
        print(f"pretrain {name}: epoch {ckpt['extra_state']['epoch']}, BatchNorm running "
              f"statistics of all four U-Nets moved", flush=True)
    return counts, folder


def pretrain_eval_phase(torch, kernels, ckpt_dir, run_dir, device="cuda", opts=(),
                        launches=PRETRAIN_EVAL_LAUNCHES):
    """Phase 7: the eval CLI of the pretrain config on the pretrain's
    checkpoint directory, with the launch counters set to 0 just before it
    and read just after. Returns its launch counts."""
    import numpy as np

    from move2hear_tpu_torch.main import main as port_main

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    ev = port_main(["--run-type", "eval", "--exp-config", PRETRAIN_EXP, "--model-dir",
                    os.path.join(run_dir, "pretrain_eval"), "--device", device,
                    "EVAL_CKPT_PATH_DIR", ckpt_dir, *opts])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    if counts != launches:
        fail(f"pretrain-eval kernel launches {counts}, expected {launches}")
    if len(ev.last_eval) != 2:
        fail(f"pretrain-eval evaluated {sorted(ev.last_eval)}, not the two best checkpoints")
    for path, res in ev.last_eval.items():
        vals = [v for split in res.values() for v in split.values()]
        if not (os.path.exists(path + ".eval.json") and np.isfinite(vals).all()):
            fail(f"pretrain-eval of {path}: no .eval.json or losses not finite: {res}")
        phase("pretrain-eval", t0, f"{os.path.basename(path)}: " + ", ".join(
            f"{split} bin {r['bin_loss']:.6f} mono {r['mono_loss']:.6f}" for split, r in res.items()))
    return counts


TRAIN_EXP = os.path.join(REPO, "configs", "train", "nearTarget.yaml")
FAR_TRAIN_EXP = os.path.join(REPO, "configs", "train", "farTarget.yaml")
FAR_EVAL_EXP = os.path.join(REPO, "configs", "test", "farTarget.yaml")
TRAIN_OPTS = ["NUM_UPDATES", "12"]


def train_phase(torch, kernels, card, run_dir, label="train", exp=TRAIN_EXP, device="cuda",
                opts=(), launches=TRAIN_LAUNCHES, pretrained=""):
    """Phases 8 and 8a: the train CLI with config `exp` at full width for 2
    cycles, its passive separators loaded from the `pretrained` checkpoint
    (seeded random ones when it is ""), with the launch counters set to 0
    just before it and read just after. Returns the path's launch counts,
    its last checkpoint and the trainer. (`device`, `opts` and `launches`
    let a rehearsal run it small on the CPU.)"""
    import numpy as np

    from move2hear_tpu_torch.main import main as port_main
    from move2hear_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    trainer = port_main(["--run-type", "train", "--exp-config", exp, "--model-dir", run_dir,
                         "--device", device, *TRAIN_OPTS,
                         "RL.PPO.pretrained_passive_separators_ckpt", pretrained, *opts])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    wall = time.perf_counter() - t0
    if counts != launches:
        fail(f"{label}-path kernel launches {counts}, expected {launches}")
    cycles = trainer.cycle_log
    if len(cycles) != 2:
        fail(f"{label} ran {len(cycles)} cycles, expected 2")
    for i, c in enumerate(cycles):
        phase(label, t0, (
            f"cycle {i} ({'cold' if i == 0 else 'warm'}): {c['env_steps']} env-steps in "
            f"{c['total']:.3f} s = {c['env_steps'] / c['total']:.1f} env-steps/s; collect "
            f"{c['collect']:.3f} s, policy update {c['update']:.3f} s, refit {c['refit']:.3f} s; "
            f"mean |reward| {c['reward_abs_mean']:.6f} ({card})"
        ))
    for i, (pol, sep) in enumerate(trainer.loss_log):
        if not (np.isfinite(pol).all() and np.isfinite(sep).all()):
            fail(f"{label} cycle {i}: losses not finite: pol {pol.tolist()} sep {sep.tolist()}")
        print(f"{label} cycle {i} losses, last update: value {pol[-1][0]:.6f} action "
              f"{pol[-1][1]:.6f} entropy {pol[-1][2]:.6f}; refit bin {sep[-1][0]:.6f} "
              f"mono {sep[-1][1]:.6f} mem {sep[-1][2]:.6f}", flush=True)
    warm = cycles[1]
    print(f"{label}: set-up {trainer.setup_s:.3f} s, warm {warm['env_steps'] / warm['total']:.1f} "
          f"env-steps/s, end to end {sum(c['env_steps'] for c in cycles) / wall:.1f} env-steps/s "
          f"over {wall:.3f} s; {label}-path launches: {counts}", flush=True)

    ckpts = sorted(f for f in os.listdir(trainer.config.CHECKPOINT_FOLDER) if f.startswith("ckpt."))
    ckpt = os.path.join(trainer.config.CHECKPOINT_FOLDER, f"ckpt.{len(cycles)}.pth")
    if not os.path.exists(ckpt):
        fail(f"{label} wrote {ckpts}, not ckpt.{len(cycles)}.pth")
    if pretrained:
        pre = load_checkpoint(pretrained)["state_dict"]
        got = load_checkpoint(ckpt)["state_dict"]
        bad = [k for k, v in pre.items() if not torch.equal(got[k], v)]
        if bad:
            fail(f"{label}: {len(bad)} passive-separator tensors differ from {pretrained}: {bad[:3]}")
        print(f"{label} started from {os.path.basename(pretrained)}: its {len(pre)} passive-separator "
              f"tensors (BatchNorm statistics included) are unchanged in {os.path.basename(ckpt)}",
              flush=True)
    return counts, ckpt, trainer


def scale_train_phase(torch, kernels, card, run_dir, device="cuda", opts=(),
                      launches=SCALE_TRAIN_LAUNCHES, pretrained="", fixture=SCALE_FIXTURE):
    """Phase 8d: the trainer as bench.py drives the JAX package, with
    configs/train/nearTarget.yaml at full width for 2 cycles on the scale
    fixture, RIR_MODE auto at the default budget, with the launch counters
    set to 0 just before it and read just after. Returns the path's launch
    counts. (`device`, `opts`, `launches` and `fixture` let a rehearsal run
    it small on the CPU.)"""
    import gc
    import resource

    import numpy as np

    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.env.micro_scene import build_scale_fixture
    from move2hear_tpu_torch.env.sub_bank import _count_unique_keys
    from move2hear_tpu_torch.rl.trainer import PPOTrainer

    t0 = time.perf_counter()
    bundle = build_scale_fixture(**fixture)
    cfg = get_config(TRAIN_EXP, [*TRAIN_OPTS, "RL.PPO.pretrained_passive_separators_ckpt",
                                 pretrained, *opts], run_dir, "train")
    on_cuda = device == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with walker_watch() as seen:
        trainer = PPOTrainer(cfg, bundle=bundle, device=device)
        trainer.train()
    if on_cuda:
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    wall = time.perf_counter() - t0
    if counts != launches:
        fail(f"scale-train-path kernel launches {counts}, expected {launches}")
    report_walker("scale-train", seen, card)
    if trainer._rir_mode != "sub":
        fail(f"scale-train: the gate chose {trainer._rir_mode!r}, not the RIR sub-banks")
    cycles, sub = trainer.cycle_log, trainer._sub_bank
    if len(cycles) != 2 or len(trainer.sub_bank_log) != 2:
        fail(f"scale-train ran {len(cycles)} cycles, expected 2")
    print(f"scale-train: {len(bundle.scenes)} scenes of V = {sub._v_pad}, {len(bundle.episodes)} "
          f"episodes, {_count_unique_keys(bundle)} (scene, source) keys; slab {sub.capacity} rows x "
          f"{sub.row_bytes / 1e6:.1f} MB = {sub.capacity * sub.row_bytes / 1e9:.2f} GB; {len(sub._key_to_slot)} "
          f"rows resident after 2 cycles", flush=True)
    for i, (c, sb) in enumerate(zip(cycles, trainer.sub_bank_log)):
        phase("scale-train", t0, (
            f"cycle {i} ({'cold' if i == 0 else 'warm'}): {c['env_steps']} env-steps in "
            f"{c['total']:.3f} s = {c['env_steps'] / c['total']:.1f} env-steps/s; collect "
            f"{c['collect']:.3f} s, policy update {c['update']:.3f} s, refit {c['refit']:.3f} s; "
            f"rows assembled {sb['rows_assembled']}, uploaded {sb['rows_uploaded']} "
            f"({sb['bytes_uploaded'] / 1e9:.3f} GB); host s in rollout_inputs "
            f"{sb['rollout_inputs_s']:.3f}, in prefetch {sb['prefetch_s']:.3f}; prefetches that "
            f"returned before the device had run the work queued ahead of them: "
            f"{sb['prefetch_busy_returns']} of "
            f"{cfg.RL.PPO.num_updates_per_cycle} ({card})"
        ))
    for i, (pol, sep) in enumerate(trainer.loss_log):
        if not (np.isfinite(pol).all() and np.isfinite(sep).all()):
            fail(f"scale-train cycle {i}: losses not finite: pol {pol.tolist()} sep {sep.tolist()}")
        print(f"scale-train cycle {i} losses, last update: value {pol[-1][0]:.6f} action "
              f"{pol[-1][1]:.6f} entropy {pol[-1][2]:.6f}; refit mem {sep[-1][2]:.6f}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_cuda else float("nan")
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    warm = cycles[1]
    print(f"scale-train: set-up {trainer.setup_s:.3f} s, warm {warm['env_steps'] / warm['total']:.1f} "
          f"env-steps/s, end to end {sum(c['env_steps'] for c in cycles) / wall:.1f} env-steps/s over "
          f"{wall:.3f} s; peak device memory allocated {peak:.2f} GB; host memory "
          f"{mem['MemTotal'] / 2**30:.1f} GiB, available {mem['MemAvailable'] / 2**30:.1f} GiB, this "
          f"process's peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB; "
          f"scale-train-path launches: {counts}", flush=True)
    slab_gather_check(torch, sub, device)
    del trainer, sub
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    return counts


def slab_gather_check(torch, sub, device="cuda"):
    """The end of phase 8d: the collect's gather from the two highest
    filled slots of the slab (past 2**31 elements at full size, where the
    index math needs 64 bits) against their rows assembled anew on the host,
    bitwise; and its device time."""
    import numpy as np

    t0 = time.perf_counter()
    by_slot = {slot: key for key, slot in sub._key_to_slot.items()}
    slots = sorted(by_slot)[-2:]
    rng = np.random.default_rng(SEED)
    n, v = 14, sub._scene_list[0].num_nodes
    rows = torch.tensor([slots] * n, dtype=torch.int32, device=device)
    az = torch.as_tensor(rng.integers(0, 4, n), device=device)
    node = torch.as_tensor(rng.integers(0, v, n), device=device)
    got = sub._slab[rows, az[:, None], node[:, None]].cpu().numpy()
    host = {s: sub._assemble_row(by_slot[s]) for s in slots}
    want = np.stack([np.stack([host[s][a, u] for s in slots])
                     for a, u in zip(az.tolist(), node.tolist())])
    if not np.array_equal(got, want):
        fail(f"scale-train: the slab gather at slots {slots} differs from the rows assembled anew "
             f"(max abs err {float(np.abs(got - want).max())})")
    offset = slots[-1] * math.prod(sub._slab.shape[1:])
    detail = ""
    if device == "cuda":
        ms = eager_ms(lambda: sub._slab[rows, az[:, None], node[:, None]])
        detail = f"; gather {ms * 1e3:.2f} us a call issued from Python ({got.nbytes} B)"
    phase("scale-train", t0, (
        f"gather of {tuple(got.shape)} from slots {slots} (element offset {offset}, "
        f"{'past' if offset >= 2**31 else 'below'} 2**31) bitwise equal to the rows assembled "
        f"anew{detail}"
    ))


def window_table_check(torch, device="cuda", n=14, t=20, windows=5):
    """The end of phase 8d: the sub-bank's episode -> slot table through
    `windows` windows of the trainer's default micro-scene (4x4, 64
    episodes, 16 source nodes), a slot per key, prefetched as the trainer
    does. Later windows bring episodes whose keys are all resident, so no
    row is uploaded for them: the slab gather must still equal the dense
    gather at every step, the bootstrap observation included, bitwise."""
    import dataclasses

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.env.micro_scene import build_micro_scene
    from move2hear_tpu_torch.env.sub_bank import RirSubBank, _count_unique_keys

    t0 = time.perf_counter()
    bundle = build_micro_scene(rows=4, cols=4, num_episodes=64, near_target=True)
    dev = torch.device(device)
    dense = de.build_device_bundle(bundle, dev)
    sub_dev = de.build_device_bundle(bundle, dev, rir_mode="sub")
    order = de.make_order_table(n, len(bundle.episodes), SEED)
    sub = RirSubBank(bundle.scenes, bundle.audio_db, sub_dev.episodes.scene_idx.cpu().numpy(),
                     sub_dev.episodes.sources.cpu().numpy(), order, t, t,
                     v_pad=int(sub_dev.scene.positions.shape[1]),
                     capacity=_count_unique_keys(bundle), device=dev)
    state = de.env_reset_all(dense.scene, dense.episodes, torch.as_tensor(order, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    quiet = 0
    for w in range(windows):
        before = sub.rows_uploaded
        slab, table = sub.rollout_inputs()
        quiet += sub.rows_uploaded == before
        dev_w = dataclasses.replace(sub_dev, rir_sub_bank=slab, ep_src_row=table)
        for step in range(t + 1):
            obs = de.observe(dense.episodes, state)
            if not torch.equal(de.gather_sensors(dev_w, obs)["rirs"],
                               de.gather_sensors(dense, obs)["rirs"]):
                fail(f"scale-parity: window {w} step {step}: the slab gather differs from the "
                     "dense gather")
            if step < t:
                actions = torch.randint(1, 4, (n,), generator=gen, device=dev)
                state, _ = de.env_step(dense.scene, dense.episodes, state, actions, t)
        sub.advance(t)
        sub.prefetch()
    phase("scale-parity", t0, (
        f"{device} episode -> slot table through {windows} windows of ({t}, {n}) (steps, envs) "
        f"on the 4x4 64-episode micro-scene, {quiet} of them uploading no row: slab gathers "
        f"bitwise equal to dense at every step"
    ))


def scale_parity_phase(torch, run_dir, device="cuda", opts=(), fixture=SCALE_PARITY_FIXTURE,
                       t=20, n=14, hid=512):
    """The end of phase 8d: the sub route against the dense route on the
    card (TF32 off, cuDNN deterministic), on a fixture small enough for
    both. One collect (t steps of n envs across an episode end, seeded
    random weights at hidden `hid`) in each mode, the sub one replaying the
    dense one's actions: the mixture magnitudes must be bitwise equal. Then
    one training cycle of configs/train/nearTarget.yaml in each mode: the
    losses within TRAIN_TOL relative, and each parameter tensor's change
    within TRAIN_DP_TOL in norm. Both modes render with per-step RIR FFTs
    (the dense route's cache of RIR rffts, PRECOMPUTE_RIR_RFFT, rounds
    otherwise), so that the RIRs' source is all that differs. It runs
    `window_table_check` between the two. (`device`,
    `opts` and the sizes let a rehearsal run it small on the CPU.)"""
    import dataclasses

    import numpy as np

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.env.micro_scene import build_scale_fixture
    from move2hear_tpu_torch.env.sub_bank import RirSubBank
    from move2hear_tpu_torch.models import Move2HearPolicy
    from move2hear_tpu_torch.rl.device_rollout import make_collect
    from move2hear_tpu_torch.rl.ppo import PPOConfig
    from move2hear_tpu_torch.rl.trainer import PPOTrainer
    from move2hear_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        bundle = build_scale_fixture(**fixture)
        dev = torch.device(device)
        torch.manual_seed(SEED + 6)
        policy = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True).to(dev).eval()
        order = de.make_order_table(n, len(bundle.episodes), SEED)
        dense = de.build_device_bundle(bundle, dev)
        sub_dev = de.build_device_bundle(bundle, dev, rir_mode="sub")
        sub = RirSubBank(bundle.scenes, bundle.audio_db, sub_dev.episodes.scene_idx.cpu().numpy(),
                         sub_dev.episodes.sources.cpu().numpy(), order, t, t,
                         v_pad=int(sub_dev.scene.positions.shape[1]), device=dev)
        slab, table = sub.rollout_inputs()
        sub_dev = dataclasses.replace(sub_dev, rir_sub_bank=slab, ep_src_row=table)
        sensors = ("mixed_bin_audio_mag", "target_class", "rgb", "depth")
        outs, actions = [], None
        for bank in (dense, sub_dev):
            sampler = None if actions is None else (lambda d, i: actions[i])
            collect = make_collect(policy, PPOConfig(), t, t, 1.2, 10.0, (1, 2, 3), sensors,
                                   sampler=sampler)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            env = de.env_reset_all(bank.scene, bank.episodes, torch.as_tensor(order, device=dev))
            out = collect(bank, env, torch.zeros((n, hid), device=dev), torch.ones((n, 1), device=dev),
                          torch.zeros((n, 512, 32, 1), device=dev), gen)
            actions = out.rollouts_pol["actions"]
            outs.append(out.rollouts_pol)
        mags = [o["observations"]["mixed_bin_audio_mag"] for o in outs]
        if not torch.equal(*mags):
            fail(f"scale-parity: sub-mode mixture magnitudes differ from dense by "
                 f"{float((mags[0] - mags[1]).abs().max())}")
        if outs[0]["masks"].min() != 0.0:
            fail("scale-parity: the collect crossed no episode end")
        del dense, sub_dev, sub, slab
        window_table_check(torch, device, n=n, t=t)

        losses, params = {}, {}
        for mode in ("dense", "sub"):
            cfg = get_config(TRAIN_EXP, ["NUM_UPDATES", "6", "RL.PPO.pretrained_passive_separators_ckpt",
                                         "", "TPU.PRECOMPUTE_RIR_RFFT", "False", *opts],
                             os.path.join(run_dir, mode), "train")
            trainer = PPOTrainer(cfg, bundle=bundle, device=device)
            start = {k: v.detach().double().cpu().numpy() for k, v in
                     trainer._new_policy().state_dict().items() if v.is_floating_point()}
            trainer._train_device(rir_mode=mode)
            losses[mode] = np.concatenate([np.ravel(x) for x in trainer.loss_log[0]]).astype(np.float64)
            ckpt = load_checkpoint(os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.1.pth"))["state_dict"]
            params[mode] = {k: ckpt[k].double().numpy() for k in start}
            del trainer
        loss_err = float(np.max(np.abs(losses["sub"] - losses["dense"])
                                / np.maximum(np.abs(losses["dense"]), 1e-30)))
        dp = {k: float(np.linalg.norm(params["sub"][k] - b) / max(np.linalg.norm(b - start[k]), 1e-30))
              for k, b in params["dense"].items() if not np.array_equal(b, start[k])}
        key = max(dp, key=dp.get)
        bitwise = all(np.array_equal(params["sub"][k], b) for k, b in params["dense"].items())
        if not loss_err <= TRAIN_TOL:
            fail(f"scale-parity: losses of sub and dense differ by {loss_err} (tol {TRAIN_TOL})")
        if not dp[key] <= TRAIN_DP_TOL:
            fail(f"scale-parity: parameter change of {key} differs by {dp[key]} relative in norm "
                 f"(tol {TRAIN_DP_TOL})")
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    phase("scale-parity", t0, (
        f"{device} sub vs dense on {fixture['num_scenes']} scenes of V = "
        f"{fixture['rows'] * fixture['cols']}: one collect over ({t}, {n}) (steps, envs) at hidden "
        f"{hid}, mixture magnitudes bitwise equal; one cycle: losses max rel err {loss_err:.3e} "
        f"(tol {TRAIN_TOL}), parameter change max rel err in norm {dp[key]:.3e} ({key}; tol "
        f"{TRAIN_DP_TOL}), parameters {'bitwise equal' if bitwise else 'not bitwise equal'}"
    ))


def train_eval_phase(run_dir, ckpt, device="cuda", opts=(), label="train"):
    """The end of phase 8: the eval CLI with configs/test/nearTarget.yaml on
    the checkpoint the near-target training wrote."""
    from move2hear_tpu_torch.main import main as port_main

    t0 = time.perf_counter()
    ev = port_main(["--run-type", "eval", "--exp-config",
                    os.path.join(REPO, "configs", "test", "nearTarget.yaml"),
                    "--model-dir", os.path.join(run_dir, "eval"), "--device", device,
                    "EVAL_CKPT_PATH_DIR", ckpt, *opts])
    agg, tm = ev.last_eval
    for k in ("mono_l2_last", "mem_l2_last", "bin_l2_all"):
        if not all(math.isfinite(v) for v in agg[k].values()):
            fail(f"eval of the trained checkpoint: {k} not finite: {agg[k]}")
    phase(label, t0, (
        f"eval of {os.path.basename(ckpt)}: {tm['episodes']} episodes, "
        f"mono_l2_last {agg['mono_l2_last']['mean']:.6f}, mem_l2_last "
        f"{agg['mem_l2_last']['mean']:.6f}, bin_l2_all {agg['bin_l2_all']['mean']:.6f}"
    ))


def require_nav_rewards(trainer, label="far-train"):
    """The end of phase 8a: every cycle of the far-target training saw a
    non-zero navigation reward."""
    for i, c in enumerate(trainer.cycle_log):
        if not c["reward_abs_mean"] > 0.0:
            fail(f"{label} cycle {i}: every navigation reward is 0")


FAR_EVAL_FIELDS = ("geo_distance_to_target_audio_source",
                   "normalized_geo_distance_to_target_audio_source", "geodesic_distance_0",
                   "euclidean_distance_0", "mono_l2_last", "mem_l2_last", "mono_si_sdr_last",
                   "monoFromMem_si_sdr_last")


def far_eval_phase(torch, kernels, card, run_dir, nav_ckpt, qi_ckpt, device="cuda", opts=(),
                   launches=FAR_EVAL_LAUNCHES, episodes=64):
    """Phase 8b: merge the far-target checkpoint (navigation) and the
    near-target one (quality improvement) with the merge CLI, then run the
    eval CLI with configs/test/farTarget.yaml on the switch checkpoint, cold
    then warm, each with the launch counters set to 0 just before it and
    read just after. Returns the far-eval path's launch counts."""
    from move2hear_tpu_torch.main import main as port_main

    t0 = time.perf_counter()
    switch = os.path.join(run_dir, "switch.pth")
    merge = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_merge_switch_ckpt.py"),
         nav_ckpt, qi_ckpt, switch], capture_output=True, text=True,
    )
    if merge.returncode != 0 or not os.path.exists(switch):
        fail(f"switch merge failed: rc {merge.returncode}: {merge.stderr[-2000:]}")
    phase("far-eval", t0, f"merged {os.path.basename(nav_ckpt)} (navigation) and "
                          f"{os.path.basename(qi_ckpt)} (quality improvement) into "
                          f"{os.path.basename(switch)}")
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        ev = port_main(["--run-type", "eval", "--exp-config", FAR_EVAL_EXP, "--model-dir",
                        os.path.join(run_dir, "far_eval"), "--device", device,
                        "EVAL_CKPT_PATH_DIR", switch, *opts])
        if device == "cuda":
            torch.cuda.synchronize()
        counts = path_counts(kernels, launches)
        wall = time.perf_counter() - t0
        if counts != launches:
            fail(f"far-eval kernel launches {counts}, expected {launches}")
        agg, tm = ev.last_eval
        cfg = ev.config
        if not (cfg.RL.PPO.switch_policy and tm["episodes"] == episodes):
            fail(f"far-eval: switch_policy {cfg.RL.PPO.switch_policy}, {tm['episodes']} "
                 f"episodes, expected the switch policy over {episodes}")
        for k in FAR_EVAL_FIELDS:
            if k not in agg or not all(math.isfinite(v) for v in agg[k].values()):
                fail(f"far-eval aggregate {k} missing or not finite: {agg.get(k)}")
        phase("far-eval", t0, (
            f"run {run}: {tm['env_steps'] / tm['loop_s']:.1f} env-steps/s over the episode loop "
            f"({tm['episodes']} episodes x {cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS} steps, "
            f"switch at step {cfg.RL.PPO.time_thres_for_pol_switch}, {tm['loop_s']:.3f} s), "
            f"set-up {tm['setup_s']:.3f} s, end to end {tm['env_steps'] / wall:.1f} env-steps/s "
            f"({card})"
        ))
    print("far-eval aggregates: " + ", ".join(
        f"{k} {agg[k]['mean']:.6f}" for k in FAR_EVAL_FIELDS) + f"; far-eval-path launches: "
        f"{counts}", flush=True)
    return counts


HOST_TRAIN_EXP = TRAIN_EXP
HOST_EVAL_EXP = os.path.join(REPO, "configs", "test", "nearTarget.yaml")
# phase 8f's budget: below both bank estimates of the fixture (1.04 GB
# dense, 0.17 GB sub-banked), so that the gate itself takes the host path
HOST_TRAIN_OPTS = ["TPU.MAX_DEVICE_BANK_BYTES", "1000000"]


def host_fixture_phase(root, fixture=HOST_FIXTURE):
    """Phase 8e: the reference's on-disk layout of `fixture` under `root`
    (``env/layout.py``): graphs, RIR wavs, mono wavs, the episode json.gz
    of each split and the per-scene observation pickles. Returns the config
    overrides that point at it."""
    from move2hear_tpu_torch.env.layout import write_soundspaces_layout

    t0 = time.perf_counter()
    lay = write_soundspaces_layout(root, **fixture)
    total = sum(lay["bytes"].values())
    n, v = fixture["num_scenes"], fixture["rows"] * fixture["cols"]
    reckoned = n * 4 * v * v * (fixture["rir_length"] * 2 * 2 + 44)
    if lay["bytes"]["rirs"] != reckoned:
        fail(f"host-fixture: {lay['bytes']['rirs']} RIR bytes written, reckoned {reckoned}")
    phase("host-fixture", t0, (
        f"{lay['files']} files, {total / 1e9:.3f} GB under {root}: {n} scenes of V = {v}, "
        f"{n * 4 * v * v} RIR wavs of {fixture['rir_length']} 16-bit stereo samples "
        f"({lay['bytes']['rirs'] / 1e9:.3f} GB, reckoned {reckoned / 1e9:.3f} GB), frames "
        f"{lay['bytes']['frames'] / 1e6:.1f} MB, mono {lay['bytes']['mono'] / 1e6:.2f} MB, "
        f"episodes of {sorted(fixture['splits'])}, {fixture['episodes_per_scene']} a scene"
    ))
    return lay["opts"]


def host_train_phase(torch, kernels, card, run_dir, fixture_opts, device="cuda", opts=(),
                     launches=HOST_TRAIN_LAUNCHES, pretrained="", cycles=2):
    """Phase 8f: the train CLI with configs/train/nearTarget.yaml at full
    width on the file-backed fixture, RIR_MODE auto with a budget below both
    bank estimates, in worker processes forked after CUDA is set up, with
    the launch counters set to 0 just before it and read just after.
    Returns the path's launch counts and its last checkpoint."""
    import numpy as np

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.env.bundle import bundle_from_config
    from move2hear_tpu_torch.env.sub_bank import estimate_sub_bank_bytes
    from move2hear_tpu_torch.main import main as port_main

    argv = [*TRAIN_OPTS, "RL.PPO.pretrained_passive_separators_ckpt", pretrained,
            *HOST_TRAIN_OPTS, *fixture_opts, *opts]
    cfg = get_config(HOST_TRAIN_EXP, argv, run_dir, "train")
    bundle = bundle_from_config(cfg.TASK_CONFIG, max_rir_length=cfg.TPU.MAX_RIR_LENGTH)
    p = cfg.RL.PPO
    dense = de.estimate_bank_bytes(bundle)
    sub = estimate_sub_bank_bytes(bundle, cfg.NUM_PROCESSES, cfg.NUM_SOUNDS_IN_MIX, p.num_steps,
                                  cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS)
    budget = int(cfg.TPU.MAX_DEVICE_BANK_BYTES)
    if not (dense > budget and sub > budget):
        fail(f"host-train: budget {budget} B is not below both estimates ({dense}, {sub} B)")
    del bundle
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with walker_watch() as seen:
        trainer = port_main(["--run-type", "train", "--exp-config", HOST_TRAIN_EXP, "--model-dir",
                             run_dir, "--device", device, *argv])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    wall = time.perf_counter() - t0
    if trainer._rir_mode != "host":
        fail(f"host-train: the gate chose {trainer._rir_mode!r}, not the host env path")
    if counts != launches:
        fail(f"host-train-path kernel launches {counts}, expected {launches}")
    if trainer.vector_env != "ProcessVectorEnv":
        fail(f"host-train stepped its envs in {trainer.vector_env}, not ProcessVectorEnv")
    report_walker("host-train", seen, card)  # the forked workers inherit the walker
    log = trainer.cycle_log
    if len(log) != cycles:
        fail(f"host-train ran {len(log)} cycles, expected {cycles}")
    print(f"host-train: gate host (dense {dense / 1e9:.3f} GB, sub-banked {sub / 1e9:.3f} GB, "
          f"budget {budget / 1e9:.6f} GB); {cfg.NUM_PROCESSES} ProcessVectorEnv workers forked "
          f"after CUDA set-up; RIR bytes shipped a step {trainer.rir_bytes_per_step} "
          f"({trainer.rir_bytes_per_step / 1e6:.3f} MB)", flush=True)
    for i, c in enumerate(log):
        phase("host-train", t0, (
            f"cycle {i} ({'cold' if i == 0 else 'warm'}): {c['env_steps']} env-steps in "
            f"{c['total']:.3f} s = {c['env_steps'] / c['total']:.1f} env-steps/s; env step "
            f"{c['env']:.3f} s, device step {c['device_step']:.3f} s, policy update "
            f"{c['update']:.3f} s, refit {c['refit']:.3f} s; mean |reward| "
            f"{c['reward_abs_mean']:.6f} ({card})"
        ))
    for i, (pol, sep) in enumerate(trainer.loss_log):
        if not (np.isfinite(pol).all() and np.isfinite(sep).all()):
            fail(f"host-train cycle {i}: losses not finite: pol {pol.tolist()} sep {sep.tolist()}")
        print(f"host-train cycle {i} losses, last update: value {pol[-1][0]:.6f} action "
              f"{pol[-1][1]:.6f} entropy {pol[-1][2]:.6f}; refit bin {sep[-1][0]:.6f} "
              f"mono {sep[-1][1]:.6f} mem {sep[-1][2]:.6f}", flush=True)
    warm = log[-1]
    print(f"host-train: set-up {trainer.setup_s:.3f} s, warm {warm['env_steps'] / warm['total']:.1f} "
          f"env-steps/s, end to end {sum(c['env_steps'] for c in log) / wall:.1f} env-steps/s over "
          f"{wall:.3f} s; host-train-path launches: {counts}", flush=True)
    ckpt = os.path.join(cfg.CHECKPOINT_FOLDER, f"ckpt.{cycles}.pth")
    if not os.path.exists(ckpt):
        fail(f"host-train wrote {sorted(os.listdir(cfg.CHECKPOINT_FOLDER))}, not {ckpt}")
    return counts, ckpt


def host_eval_phase(torch, kernels, card, run_dir, fixture_opts, ckpt, switch_ckpt,
                    device="cuda", opts=(), episodes=8, switch_episodes=2,
                    launches=HOST_EVAL_LAUNCHES, switch_launches=HOST_SWITCH_EVAL_LAUNCHES):
    """Phase 8g: the eval CLI routed to the host evaluator (fewer episodes
    than TPU.DEVICE_EVAL_MIN_EPISODES) over the fixture: near-target on
    8f's checkpoint with COMPUTE_EVAL_METRICS, then the switch policy on
    8b's merged checkpoint; each with the launch counters set to 0 just
    before it and read just after. Returns both runs' launch counts."""
    from move2hear_tpu_torch.main import main as port_main

    out = []
    for label, exp, path, n, want in (
        ("host-eval", HOST_EVAL_EXP, ckpt, episodes, launches),
        ("host-switch-eval", FAR_EVAL_EXP, switch_ckpt, switch_episodes, switch_launches),
    ):
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        with walker_watch() as seen:
            ev = port_main(["--run-type", "eval", "--exp-config", exp, "--model-dir",
                            os.path.join(run_dir, label), "--device", device,
                            "EVAL_CKPT_PATH_DIR", path, "EVAL_EPISODE_COUNT", str(n),
                            *fixture_opts, *opts])
        if device == "cuda":
            torch.cuda.synchronize()
        counts = path_counts(kernels, want)
        wall = time.perf_counter() - t0
        agg, tm = ev.last_eval
        if ev._eval_route != "host":
            fail(f"{label}: routed to the {ev._eval_route} evaluator, not the host one")
        if counts != want:
            fail(f"{label}-path kernel launches {counts}, expected {want}")
        keys = ["mono_l2_last", "mem_l2_last", "bin_l2_all", "geo_distance_to_target_audio_source"]
        for k in keys:
            if k not in agg or not all(math.isfinite(v) for v in agg[k].values()):
                fail(f"{label}: aggregate {k} missing or not finite: {agg.get(k)}")
        if tm["episodes"] != n:
            fail(f"{label}: {tm['episodes']} episodes, expected {n}")
        report_walker(label, seen, card)
        phase(label, t0, (
            f"{tm['episodes']} episodes x {tm['env_steps'] // n} steps on the file-backed fixture: "
            f"{tm['env_steps'] / tm['loop_s']:.1f} env-steps/s over the episode loop "
            f"({tm['loop_s']:.3f} s), set-up {tm['setup_s']:.3f} s, end to end "
            f"{tm['env_steps'] / wall:.1f} env-steps/s; " + ", ".join(
                f"{k} {agg[k]['mean']:.6f}" for k in keys) + f"; {label}-path launches: "
            f"{counts} ({card})"
        ))
        out.append(counts)
    return out


HOST_PARITY_L2_TOL = 1e-4   # relative, per-step STFT-L2 (the CPU reads 1.1e-7)
HOST_PARITY_SI_TOL = 0.05   # dB, per-step SI-SDR above -40 dB (the CPU reads 1.0e-5)


def host_parity_phase(torch, run_dir, fixture_opts, ckpt, device="cuda", opts=(), scenes=2,
                      card="cpu"):
    """Phase 8h: with TF32 off and deterministic actions, the host evaluator
    against the device evaluator on the same fixture episodes (the first
    `scenes` scenes, every episode): per episode, keyed by (scene, episode
    id), equal actions, per-step STFT-L2 within HOST_PARITY_L2_TOL relative
    and SI-SDR within HOST_PARITY_SI_TOL dB above -40 dB."""
    import pickle

    import numpy as np

    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.env.bundle import bundle_from_config
    from move2hear_tpu_torch.eval.device_evaluator import evaluate_checkpoint_device
    from move2hear_tpu_torch.eval.evaluator import evaluate_checkpoint

    t0 = time.perf_counter()
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(HOST_EVAL_EXP, ["RL.PPO.deterministic_eval", "True", *fixture_opts, *opts],
                     run_dir, "eval")
    dumps, actions = [], []
    with walker_watch() as seen:
        full = bundle_from_config(cfg.TASK_CONFIG, max_rir_length=cfg.TPU.MAX_RIR_LENGTH)
        bundle = full.for_scenes(sorted(full.scenes)[:scenes])
        n = len(bundle.episodes)
        for i, evaluate in enumerate((evaluate_checkpoint, evaluate_checkpoint_device)):
            acts = {}
            evaluate(cfg, ckpt, i, bundle=bundle, episode_count=n, device=device,
                     actions_out=acts)
            with open(os.path.join(run_dir, f"eval_metrics_ckpt_{i}.pkl"), "rb") as f:
                dumps.append(pickle.load(f))
            actions.append(acts)
    report_walker("host-parity", seen, card)
    host, dev = dumps
    if sorted(actions[0]) != sorted(actions[1]) or len(actions[0]) != n:
        fail(f"host-parity: episodes differ: {sorted(actions[0])} vs {sorted(actions[1])}")
    rel, si = 0.0, []
    for key, acts in actions[0].items():
        if acts != actions[1][key]:
            fail(f"host-parity: episode {key}: actions {acts} on the host, {actions[1][key]} on the "
                 "device")
        for m in ("mono_l2", "mem_l2", "bin_l2"):
            h, d = np.asarray(host[str(key)][m]), np.asarray(dev[str(key)][m])
            rel = max(rel, float(np.max(np.abs(h - d) / np.abs(d))))
        for qh, qd in zip(host[str(key)]["quality"], dev[str(key)]["quality"]):
            si += [(qh[r]["si_sdr"], qd[r]["si_sdr"]) for r in ("mono", "monoFromMem")]
    si = np.asarray(si)
    ok = si[:, 1] > -40.0  # below -40 dB the metric is ill-conditioned
    si_err = float(np.max(np.abs(si[ok, 0] - si[ok, 1]))) if ok.any() else 0.0
    if not rel <= HOST_PARITY_L2_TOL:
        fail(f"host-parity: per-step STFT-L2 relative error {rel} > {HOST_PARITY_L2_TOL}")
    if not si_err <= HOST_PARITY_SI_TOL:
        fail(f"host-parity: SI-SDR differs by {si_err} dB > {HOST_PARITY_SI_TOL} dB")
    phase("host-parity", t0, (
        f"host evaluator vs device evaluator over {n} episodes of {scenes} fixture scenes: actions "
        f"equal; per-step STFT-L2 max rel err {rel:.3e} (tol {HOST_PARITY_L2_TOL}); SI-SDR max abs "
        f"diff {si_err:.4f} dB over {int(ok.sum())} entries above -40 dB (tol {HOST_PARITY_SI_TOL})"
    ))


def synthetic_rollout(seed, t, n, hidden, num_actions, n_poses=None, frames=False):
    """A PPO rollout in the layout make_update_pol reads (the JAX package's
    and the port's), as numpy arrays from `seed`: (T+1)-slot observations
    with pose indices in [0, n_poses) or frames, hidden states, separator
    outputs, masks with an episode reset half-way, values, rewards,
    returns (GAE, gamma 0.99, tau 0.95), actions and their old log-probs
    near uniform."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    obs = {
        "mixed_bin_audio_mag": np.abs(rng.standard_normal((t + 1, n, 512, 32, 2))).astype(f32),
        "target_class": rng.integers(0, 2, (t + 1, n, 1)).astype(np.int64),
    }
    if n_poses is not None:
        obs["pose"] = rng.integers(0, n_poses, (t + 1, n)).astype(np.int64)
    if frames:
        obs["rgb"] = rng.integers(0, 256, (t + 1, n, 128, 128, 3)).astype(np.uint8)
        obs["depth"] = rng.uniform(0, 1, (t + 1, n, 128, 128, 1)).astype(f32)
    masks = np.ones((t + 1, n, 1), f32)
    masks[t // 2 + 1, : max(1, n // 2)] = 0.0  # those envs start a new episode
    rewards = (0.1 * rng.standard_normal((t, n, 1))).astype(f32)
    values = (0.1 * rng.standard_normal((t + 1, n, 1))).astype(f32)
    gae, returns = np.zeros((n, 1), f32), np.zeros((t + 1, n, 1), f32)
    returns[t] = values[t]
    for i in reversed(range(t)):
        delta = rewards[i] + 0.99 * values[i + 1] * masks[i + 1] - values[i]
        gae = delta + 0.99 * 0.95 * masks[i + 1] * gae
        returns[i] = gae + values[i]
    return {
        "observations": obs,
        "hidden": (0.5 * rng.standard_normal((t + 1, n, hidden))).astype(f32),
        "pred_binSepMasks": rng.uniform(0.0, 1.2, (t, n, 512, 32, 2)).astype(f32),
        "pred_mono": np.abs(rng.standard_normal((t, n, 512, 32, 1))).astype(f32),
        "prev_pred_monoFromMem": np.abs(rng.standard_normal((t + 1, n, 512, 32, 1))).astype(f32),
        "rewards": rewards,
        "value_preds": values,
        "returns": returns,
        "action_log_probs": (np.log(1.0 / num_actions)
                             + 0.05 * rng.standard_normal((t, n, 1))).astype(f32),
        "actions": rng.integers(0, num_actions, (t, n, 1)).astype(np.int64),
        "masks": masks,
    }


def synthetic_sep_slab(seed, t, n):
    """The refit's cached slabs (T, N, ...) as numpy arrays from `seed`:
    pred_mono, gt_mono, prev_mem, masks (a reset half-way), logging L1s."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    masks = np.ones((t, n, 1), f32)
    masks[t // 2, : max(1, n // 2)] = 0.0
    return {
        "pred_mono": np.abs(rng.standard_normal((t, n, 512, 32, 1))).astype(f32),
        "gt_mono": np.abs(rng.standard_normal((t, n, 512, 32, 1))).astype(f32),
        "prev_mem": np.abs(rng.standard_normal((t, n, 512, 32, 1))).astype(f32),
        "masks": masks,
        "bin_l1": rng.uniform(0, 1, (t, n)).astype(f32),
        "mono_l1": rng.uniform(0, 1, (t, n)).astype(f32),
    }


def train_parity_phase(torch, devices=("cuda", "cpu"), t=20, n=14, hid=512):
    """Phase 9: one PPO update (4 epochs, pose bank) and one separator refit
    (4 grad steps) on one injected full-width rollout (20 steps x 14 envs,
    hidden 512), from the same seeded weights, in five runs: A on
    devices[0] (the card, TF32 off); B on devices[1] (the CPU); D as B in
    float64, the reference; D|A as D, but every ReLU passes or zeroes its
    input as A's did in the same call (float64 arithmetic on A's branches);
    D|B the same on B's branches. On a card, a control T as A with TF32 on,
    and D|T on T's branches. (`devices` and the sizes let a rehearsal run it
    small on the CPU.)

    A pair is read on its losses (relative) and, per parameter tensor, on
    the change from the starting weights: dp = ||dp_x - dp_y|| / ||dp_y||
    (and, printed, element by element max |p_x - p_y| / (|p_y| + lr)).
    Gates: the losses of A against B and against D within TRAIN_TOL; dp of
    every tensor of A against D|A and of B against D|B within TRAIN_DP_TOL;
    and dp of T against D|T above TRAIN_DP_TOL, so the gate is shown to
    fail a lower precision. Printed beside them: A against D, B against D,
    A against B, and each float32 run's ReLU units whose sign differs from
    D's, by module and epoch, with D's pre-activation there. Where a float32
    run flips a unit whose float64 input is within rounding of zero, the
    gradients it feeds part from there, and Adam (eps 1e-5) carries that
    into later steps by far more than rounding: so the gate holds each
    float32 run to the float64 run on its own branches."""
    import numpy as np

    import move2hear_tpu_torch.models.audio_cnn as audio_cnn
    from move2hear_tpu_torch.models import Move2HearPolicy
    from move2hear_tpu_torch.rl.device_rollout import RolloutSepIdx, make_update_sep_from_slabs
    from move2hear_tpu_torch.rl.ppo import PPOConfig, create_agent_state, make_update_pol

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PPOConfig()
    roll = synthetic_rollout(SEED + 2, t, n, hid, 3, n_poses=64)
    slab = synthetic_sep_slab(SEED + 3, t, n)
    rng = np.random.default_rng(SEED + 4)
    banks = {"rgb": rng.integers(0, 256, (1, 16, 4, 128, 128, 3)).astype(np.uint8),
             "depth": rng.uniform(0, 1, (1, 16, 4, 128, 128, 1)).astype(np.float32)}
    torch.manual_seed(SEED + 5)
    weights = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True).state_dict()
    start = {k: v.double().numpy() for k, v in weights.items() if v.is_floating_point()}
    lr = {k: cfg.lr_sep if k.startswith("acoustic_mem.") else cfg.lr_pol for k in start}
    kernel = audio_cnn.masked_mix_slice16

    def run(name, dtype=torch.float32, follow=None, tf32=False):
        """(losses, parameters, bin-encoder inputs, ReLU inputs by module)
        of one update and refit; with `follow` (another run's ReLU inputs by
        module), each ReLU call keeps its input where that run's was
        positive and zeroes it elsewhere."""
        dev = torch.device(name)
        seen, relu_in = [], {}

        def on(x):
            if isinstance(x, dict):
                return {k: on(v) for k, v in x.items()}
            v = torch.from_numpy(x)
            return (v.to(dtype) if v.is_floating_point() else v).to(dev)

        def bin_input(mix, mask):
            out = kernel(mix, mask)
            seen.append(out.detach().cpu())
            return out

        policy = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True)
        policy.load_state_dict(weights)
        policy = policy.to(dev, dtype)
        hooks = []
        for mname, m in policy.named_modules():
            if isinstance(m, torch.nn.ReLU):
                hooks.append(m.register_forward_hook(
                    lambda m, i, o, mname=mname: relu_in.setdefault(mname, []).append(
                        i[0].detach().double().cpu())))
                if follow is not None:
                    signs = iter(follow.get(mname, ()))
                    hooks.append(m.register_forward_hook(
                        lambda m, i, o, signs=signs: torch.where(
                            next(signs).to(i[0].device) > 0, i[0], torch.zeros_like(i[0]))))
            elif dtype != torch.float32 and isinstance(m, torch.nn.Conv2d):
                # the visual encoder casts its frames to float32
                hooks.append(m.register_forward_pre_hook(
                    lambda m, i: tuple(x.to(m.weight.dtype) for x in i)))
        state = create_agent_state(cfg, policy)
        audio_cnn.masked_mix_slice16 = bin_input
        default = torch.get_default_dtype()
        torch.set_default_dtype(dtype)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            pol = make_update_pol(policy, cfg, n, pose_bank=True)(state, on(roll), banks=on(banks))
            buf = RolloutSepIdx.create(t, n, 2, device=dev)
            for k, v in slab.items():
                setattr(buf, k, on(v))
            sep = make_update_sep_from_slabs(policy, cfg, 1)(state, buf, None, [1.0])
        finally:
            audio_cnn.masked_mix_slice16 = kernel
            torch.set_default_dtype(default)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            for h in hooks:
                h.remove()
        return (torch.cat([pol.reshape(-1), sep.reshape(-1)]).cpu().double().numpy(),
                {k: v.detach().cpu().double().numpy() for k, v in policy.state_dict().items()
                 if v.is_floating_point()}, seen, relu_in)

    control = torch.device(devices[0]).type == "cuda"
    runs = {"A": run(devices[0]), "B": run(devices[1])}
    runs["D"] = run(devices[1], dtype=torch.float64)
    runs["D|A"] = run(devices[1], dtype=torch.float64, follow=runs["A"][3])
    runs["D|B"] = run(devices[1], dtype=torch.float64, follow=runs["B"][3])
    if control:
        runs["T"] = run(devices[0], tf32=True)
        runs["D|T"] = run(devices[1], dtype=torch.float64, follow=runs["T"][3])
    fed = max(float((a - b).abs().max()) for a, b in zip(runs["A"][2], runs["B"][2]))
    n_diff = sum(int((a != b).sum()) for a, b in zip(runs["A"][2], runs["B"][2]))
    n_all = sum(a.numel() for a in runs["A"][2])
    if not fed <= KERNEL_TOL:
        fail(f"train-parity: bin-encoder inputs of {devices[0]} and {devices[1]} differ by {fed}")

    def compare(x, y):
        (la, pa, _, _), (lb, pb, _, _) = runs[x], runs[y]
        loss = float(np.max(np.abs(la - lb) / np.maximum(np.abs(lb), 1e-30)))
        dp = {k: float(np.linalg.norm(pa[k] - b) / max(np.linalg.norm(b - start[k]), 1e-30))
              for k, b in pb.items() if not np.array_equal(b, start[k])}
        elem = {k: float(np.max(np.abs(pa[k] - b) / (np.abs(b) + lr[k]))) for k, b in pb.items()}
        top = sorted(dp.items(), key=lambda kv: -kv[1])[:3]
        ek = max(elem, key=elem.get)
        print(f"train-parity {x} vs {y}: losses max rel err {loss:.3e}; dp max rel err in norm "
              + ", ".join(f"{v:.3e} ({k})" for k, v in top)
              + f"; elementwise max {elem[ek]:.3e} ({ek}); {len(dp)} tensors moved", flush=True)
        return loss, top[0]

    def flips(x):
        """ReLU units whose input sign differs from D's: (module, call) ->
        (count, largest |input| of D there)."""
        out = {}
        for mname, calls in runs["D"][3].items():
            for i, (a, d) in enumerate(zip(runs[x][3][mname], calls)):
                f = (a > 0) != (d > 0)
                if f.any():
                    out[f"{mname}#{i + 1}"] = (int(f.sum()), float(d.abs()[f].max()))
        print(f"train-parity {x} vs D: ReLU units of another sign (module#call: count, largest "
              f"|D input| there): {out or 'none'}", flush=True)

    pairs = [("A", "D|A"), ("B", "D|B"), ("A", "D"), ("B", "D"), ("A", "B")]
    readings = {pair: compare(*pair) for pair in pairs + [("T", "D|T")] * control}
    flips("A")
    flips("B")
    for pair in (("A", "D"), ("A", "B")):
        if not readings[pair][0] <= TRAIN_TOL:
            fail(f"train-parity {pair[0]} vs {pair[1]}: losses rel err {readings[pair][0]} "
                 f"(tol {TRAIN_TOL})")
    for x, y in pairs[:2]:
        key, dp = readings[(x, y)][1]
        if not dp <= TRAIN_DP_TOL:
            fail(f"train-parity {x} vs {y}: parameter change of {key} differs by {dp} "
                 f"relative in norm (tol {TRAIN_DP_TOL})")
    if control and not readings[("T", "D|T")][1][1] > TRAIN_DP_TOL:
        fail(f"train-parity control: TF32 on reads {readings[('T', 'D|T')][1]}, inside the "
             f"gate (tol {TRAIN_DP_TOL}), so the gate cannot tell a lower precision")
    (ka, dpa), (kb, dpb) = readings[("A", "D|A")][1], readings[("B", "D|B")][1]
    phase("train-parity", t0, (
        f"A {devices[0]} vs D {devices[1]} float64, one update (4 epochs) + one refit (4 "
        f"steps) over ({t}, {n}) at hidden {hid}: losses within {TRAIN_TOL} of D; every "
        f"parameter change within {TRAIN_DP_TOL} in norm of the float64 run on its own ReLU "
        f"sides (A {dpa:.3e}, {ka}; B {dpb:.3e}, {kb}; A against D {readings[('A', 'D')][1][1]:.3e})"
        + (f"; TF32 control {readings[('T', 'D|T')][1][1]:.3e} ({readings[('T', 'D|T')][1][0]}), "
           f"outside it" if control else "")
        + f"; bin-encoder inputs of A and B differ in {n_diff} of {n_all} elements, by at most "
        f"{fed:.3e}"
    ))


def pretrain_parity_phase(torch, devices=("cuda", "cpu"), b=16):
    """Phase 10: one pretrain train step and one eval step at full width
    (the four U-Nets) and batch `b`, from the same seeded weights and numpy
    batches (the default train source), in four runs: A on devices[0] (the
    card, TF32 off); B on devices[1] (the CPU) in float32; D as B in
    float64; D|A as D, but every ReLU and LeakyReLU unit and every L1 term
    takes the side A took in the same call (float64 arithmetic on A's
    branches). All four take one float32 render of each batch, the CPU's
    (two renders differ by f16 ulps; the render itself is held card against
    CPU by phase 5). (`devices` and `b` let a rehearsal run it small.)

    Gates, each within TRAIN_TOL: the losses of both steps, A against D;
    per tensor, in norm, A's gradient against D|A's and A's change of every
    BatchNorm statistic against D|A's; and every parameter of A after the
    step against a float64 Adam step taken from A's own gradients, element
    by element relative to |p| + lr (a float32 parameter near 1 holds a
    change of lr = 5e-4 only to 1.2e-4 of itself). A's parameters against
    D's are printed beside them, not gated: the L1 loss's gradient is a
    sign, so one term that a float32 prediction puts on the other side of
    its target moves a gradient by about 2/sqrt(terms) (0.4% at B=16), and
    training-mode BatchNorm cancels most of the gradient of the layers
    before it, so entries near Adam's eps (1e-5) carry float32 rounding into
    the step times lr / 1e-5 (1.0e-4 to 2.5e-3 of |p| + lr between the
    CPU's float32 and float64 runs at B=16)."""
    import numpy as np

    import move2hear_tpu_torch.pretrain.trainer as pretrain_trainer
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.models import Move2HearPassiveWoMemoryPolicy
    from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(PRETRAIN_EXP, ["Pretrain.Passive.BATCH_SIZE", str(b)],
                     os.path.join(REPO, "_smoke_run"), None)
    src = SyntheticPassiveSource(num_datapoints=256, seed=0)
    rng = np.random.default_rng(SEED + 6)
    batches = (src.sample_batch(rng, b), src.sample_batch(rng, b, deterministic=True))
    weights = Move2HearPassiveWoMemoryPolicy(
        generator=torch.Generator().manual_seed(SEED + 7)).state_dict()
    start = {k: v.double().numpy() for k, v in weights.items() if v.is_floating_point()}

    def trainer_on(name):
        return pretrain_trainer.PassiveTrainer(
            cfg, sources=dict.fromkeys(("train", "val", "nonoverlapping_val"), src), device=name,
            weights=weights)

    cpu = trainer_on(devices[1])
    rendered = [cpu.render(cpu.to_device(batch)) for batch in batches]

    def run(name, dtype=torch.float32, follow=None):
        """(losses, gradients, state, kink sides by site) of one train and
        one eval step; with `follow` (another run's kink sides), every kink
        takes that run's side."""
        trainer = trainer_on(name)
        policy = trainer.new_policy().to(dtype)
        opt = trainer.new_optimizer(policy)
        sides, hooks = {}, []

        def side(site, x, on_pos, on_neg):
            """Record which side of its kink each element of x is on, and
            evaluate the branch there (the followed run's side if any)."""
            calls = sides.setdefault(site, [])
            pos = (x > 0) if follow is None else follow[site][len(calls)].to(x.device)
            calls.append((x > 0).cpu())
            return torch.where(pos, on_pos, on_neg)

        for mname, m in policy.named_modules():
            if isinstance(m, (torch.nn.ReLU, torch.nn.LeakyReLU)):
                slope = m.negative_slope if isinstance(m, torch.nn.LeakyReLU) else 0.0
                hooks.append(m.register_forward_hook(
                    lambda m, i, o, mname=mname, slope=slope: side(mname, i[0], i[0], slope * i[0])))
        # L1 with its kink recorded under the target's name
        loss = {k: (lambda p, t, k=k: (lambda d: side(f"l1:{k}", d, d, -d).mean())(p - t))
                for k in pretrain_trainer.LOSS_TARGETS}
        try:
            train_in, eval_in = ({k: v.to(name) for k, v in r.items()} for r in rendered)
            losses = [trainer.train_step(policy, opt, train_in, loss)]
            grads = {n: p.grad.detach().cpu().double().numpy() for n, p in policy.named_parameters()}
            losses.append(trainer.eval_step(policy, eval_in, loss))
        finally:
            for h in hooks:
                h.remove()
        return (torch.cat(losses).cpu().double().numpy(), grads,
                {k: v.detach().cpu().double().numpy() for k, v in policy.state_dict().items()
                 if v.is_floating_point()}, sides)

    runs = {"A": run(devices[0]), "B": run(devices[1]), "D": run(devices[1], torch.float64)}
    runs["D|A"] = run(devices[1], torch.float64, follow=runs["A"][3])
    # a float64 Adam step from A's own (clipped) gradients
    ref = trainer_on(devices[1])
    policy = ref.new_policy().double()
    opt = ref.new_optimizer(policy)
    for n, p in policy.named_parameters():
        p.grad = torch.from_numpy(runs["A"][1][n].copy())
    opt.step(ref._lr)
    adam = {k: v.numpy() for k, v in policy.state_dict().items() if v.is_floating_point()}

    def rel(x, y, base):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(base), 1e-30))

    lr = cfg.Pretrain.Passive.lr

    def state(y):
        return adam if y == "Adam(A)" else runs[y][2]

    def dp(x, y, keys):
        """Per tensor, the change from the start against y's, in norm."""
        px, py = state(x), state(y)
        return {k: rel(px[k], py[k], py[k] - start[k]) for k in keys}

    def elem(x, y, keys):
        """Per tensor, max |p_x - p_y| / (|p_y| + lr)."""
        px, py = state(x), state(y)
        return {k: float(np.max(np.abs(px[k] - py[k]) / (np.abs(py[k]) + lr))) for k in keys}

    def top(errs, n=3):
        return ", ".join(f"{v:.3e} ({k})" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:n])

    params = [n for n in runs["A"][1]]
    stats = [k for k in start if "running_" in k]
    for x, y in (("A", "D"), ("A", "D|A"), ("B", "D"), ("A", "B")):
        loss = float(np.max(np.abs(runs[x][0] - runs[y][0]) / np.abs(runs[y][0])))
        grad = {n: rel(runs[x][1][n], runs[y][1][n], runs[y][1][n]) for n in params}
        print(f"pretrain-parity {x} vs {y}: losses (train bin, mono, eval bin, mono) max rel err "
              f"{loss:.3e}; gradient max rel err in norm {top(grad, 2)}; parameters (of |p| + lr) "
              f"{top(elem(x, y, params), 2)}; BatchNorm statistics change {top(dp(x, y, stats), 2)}",
              flush=True)
    flips = {site: sum(int((a != d).sum()) for a, d in zip(runs["A"][3][site], calls))
             for site, calls in runs["D"][3].items()}
    print(f"pretrain-parity A vs D: kink sides that differ (site: count): "
          f"{({k: v for k, v in flips.items() if v} or 'none')}", flush=True)

    gates = {
        "losses A vs D": float(np.max(np.abs(runs["A"][0] - runs["D"][0]) / np.abs(runs["D"][0]))),
        "gradient A vs D|A": max(rel(runs["A"][1][n], runs["D|A"][1][n], runs["D|A"][1][n])
                                 for n in params),
        "BatchNorm statistics change A vs D|A": max(dp("A", "D|A", stats).values()),
        "parameters A vs Adam(A), of |p| + lr": max(elem("A", "Adam(A)", params).values()),
    }
    for name, err in gates.items():
        if not err <= TRAIN_TOL:
            fail(f"pretrain-parity {name}: {err} (tol {TRAIN_TOL})")
    phase("pretrain-parity", t0, (
        f"A {devices[0]} vs float64 on {devices[1]}, one train step and one eval step at batch "
        f"{b}, {len(params)} parameter and {len(stats)} statistic tensors: within {TRAIN_TOL}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gates.items())
    ))


def parity_phase(torch, switch=False, devices=("cuda", "cpu"), n_envs=8, hid=512):
    """Phase 5 (and 8c with `switch`): the same short deterministic eval on
    the card and on the CPU. The switch-policy eval runs a navigation and a
    quality-improvement policy (different seeds) on the far-target
    micro-scene, switching at step 3 of 5. (`devices`, `n_envs` and `hid`
    let a rehearsal run it small on the CPU alone.)"""
    import numpy as np

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.env.micro_scene import build_micro_scene
    from move2hear_tpu_torch.eval.device_evaluator import make_device_eval
    from move2hear_tpu_torch.models import Move2HearPolicy

    name = "switch-parity" if switch else "parity"
    t0 = time.perf_counter()
    if "cuda" in devices:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    steps, switch_at = 5, 3
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=n_envs, rir_length=4000,
                               near_target=not switch)
    weights = []
    for seed in ((SEED + 1, SEED + 2) if switch else (SEED + 1,)):
        torch.manual_seed(seed)
        weights.append(Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True).state_dict())
    outs = {}
    for i, name_dev in enumerate(devices):
        dev = torch.device(name_dev)
        policies = []
        for w in weights:
            policy = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True)
            policy.load_state_dict(w)
            policies.append(policy.to(dev).eval())
        bank = de.build_device_bundle(bundle, dev, precompute_rir_rfft=True)
        fn = make_device_eval(policies[0], policies[-1], steps, 1.2, (1, 2, 3), True,
                              switch_policy=switch, time_thres=switch_at,
                              compute_waveform_metrics=True)
        order = torch.arange(n_envs, device=dev)[:, None]
        with torch.inference_mode():
            _, _, o = fn(bank, de.env_reset_all(bank.scene, bank.episodes, order), None)
        outs[i] = {k: v.cpu().numpy() for k, v in o.items()}
    g, c = outs[0], outs[1]
    if not np.array_equal(g["action"], c["action"]):
        fail(f"{name}: actions differ: {devices[0]} {g['action'].tolist()} "
             f"{devices[1]} {c['action'].tolist()}")
    if not np.array_equal(g["geo"], c["geo"]):
        fail(f"{name}: distances differ: {g['geo'].tolist()} vs {c['geo'].tolist()}")
    rel = max(float(np.max(np.abs(g[k] - c[k]) / np.abs(c[k]))) for k in ("mono_l2", "mem_l2", "bin_l2"))
    if not rel <= 1e-4:
        fail(f"{name}: per-step STFT-L2 relative error {rel} > 1e-4")
    si_g, si_c = g["si_mono"][..., 0], c["si_mono"][..., 0]
    ok = si_c > -40.0  # below -40 dB the metric is ill-conditioned
    si_err = float(np.max(np.abs(si_g - si_c)[ok])) if ok.any() else 0.0
    if not si_err <= 0.05:
        fail(f"{name}: SI-SDR differs by {si_err} dB > 0.05 dB")
    what = f"switch at step {switch_at}, " if switch else ""
    phase(name, t0, (
        f"{devices[0]} vs {devices[1]} over ({steps}, {n_envs}) (steps, envs), {what}actions "
        f"equal; per-step STFT-L2 max rel err {rel:.3e} (tol 1e-4); SI-SDR max abs diff "
        f"{si_err:.4f} dB over {int(ok.sum())} entries above -40 dB (tol 0.05)"
    ))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# the DDPPO tests' rank launcher (tests/_torch_ddppo_rank.py): the train CLI
# with test hooks, saving the final weights and losses with torch.save; its
# M2H_TEST_FLOAT64 runs the policy in float64 on the float32 render
RANK_HELPER = os.path.join(REPO, "tests", "_torch_ddppo_rank.py")


def launch_ranks(run_dir, tag, opts, device="cuda:0", env=None, ranks=DDPPO_RANKS,
                 helper=False):
    """`ranks` processes of the train CLI with configs/train/nearTarget.yaml
    in run_dir/tag, a gloo world on the loopback; each writes its report to
    run_dir/tag/report{rank}.json (with `helper`, through RANK_HELPER, whose
    run_dir/tag/report{rank}.pt holds the final weights and the losses and
    which writes no checkpoint). Returns (Popens, report paths)."""
    out = os.path.join(run_dir, tag)
    os.makedirs(out, exist_ok=True)
    port = free_port()
    procs, reports = [], []
    for r in range(ranks):
        e = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
             "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": str(ranks), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             **(env or {})}
        reports.append(os.path.join(out, f"report{r}." + ("pt" if helper else "json")))
        entry = ([RANK_HELPER, reports[-1]] if helper
                 else ["-m", "move2hear_tpu_torch.main", "--report", reports[-1]])
        procs.append(subprocess.Popen(
            [sys.executable, *entry, "--run-type", "train", "--exp-config", TRAIN_EXP,
             "--model-dir", out, "--device", device, *TRAIN_OPTS, *DDPPO_OPTS, *opts],
            cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, reports


def wait_ranks(label, procs, reports, timeout=600):
    """Each rank's report, after every rank exited 0; a rank that fails or
    outlives `timeout` fails the phase (all ranks are stopped)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        fail(f"{label}: a rank outlived {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{label}: rank {r} exited {p.returncode}:\n{out[-6000:]}")
    result = []
    for path in reports:
        if path.endswith(".pt"):
            import torch

            result.append(torch.load(path, map_location="cpu", weights_only=False))
            continue
        with open(path) as f:
            result.append(json.load(f))
    return result, outs


def ddppo_phase(torch, card, run_dir, pretrained, device="cuda:0", opts=(),
                launches=DDPPO_TRAIN_LAUNCHES):
    """Phase 8i: DDPPO, 2 ranks of the train CLI on the one card over gloo
    (subprocesses with RANK and WORLD_SIZE), 7 envs each (phase 8's 14 in
    all), from phase 6's separators. (`device`, `opts` and `launches` let a
    rehearsal run it small on the CPU.) Returns the world's launch counts."""
    import numpy as np

    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.utils.checkpoint import load_checkpoint

    pre = ["RL.PPO.pretrained_passive_separators_ckpt", pretrained, *opts]
    states = os.path.join(run_dir, "interrupted")
    env = {"INTERRUPTED_STATE_DIR": states}

    # the 2-rank run: 2 cycles
    t0 = time.perf_counter()
    procs, reports = launch_ranks(run_dir, "world", pre, device, env)
    ranks, _ = wait_ranks("ddppo", procs, reports)
    wall = time.perf_counter() - t0
    for r, rep in enumerate(ranks):
        if rep["launches"] != launches:
            fail(f"ddppo rank {r}: kernel launches {rep['launches']}, expected {launches}")
        if len(rep["cycle_log"]) != 2:
            fail(f"ddppo rank {r} ran {len(rep['cycle_log'])} cycles, expected 2")
        for i, (pol, sep) in enumerate(rep["loss_log"]):
            if not (np.isfinite(pol).all() and np.isfinite(sep).all()):
                fail(f"ddppo rank {r} cycle {i}: losses not finite")
    if ranks[0]["params_sha256"] != ranks[1]["params_sha256"]:
        fail("ddppo: the ranks' final parameters differ")
    warm = [rep["cycle_log"][1] for rep in ranks]
    rates = [c["env_steps"] / c["total"] for c in warm]
    for r, (rep, c) in enumerate(zip(ranks, warm)):
        mem = rep["max_memory_allocated"]
        phase("ddppo", t0, (
            f"rank {r} on {rep['device']} (gloo): set-up {rep['setup_s']:.3f} s; warm cycle "
            f"{c['env_steps']} env-steps in {c['total']:.3f} s = {rates[r]:.1f} env-steps/s; "
            f"collect {c['collect']:.3f} s, policy update {c['update']:.3f} s, refit "
            f"{c['refit']:.3f} s; collectives {c['comm_s']:.3f} s in {c['comm_calls']} calls; "
            f"peak device memory "
            + (f"{mem / 2**30:.2f} GiB" if mem is not None else "not measured") + f" ({card})"
        ))
    print(f"ddppo: backend gloo, {len(ranks)} ranks x 7 envs on one card; world warm "
          f"{sum(rates):.1f} env-steps/s; end to end "
          f"{sum(c['env_steps'] for rep in ranks for c in rep['cycle_log']) / wall:.1f} "
          f"env-steps/s over {wall:.3f} s (launch included); final parameters bitwise equal "
          f"(sha256 {ranks[0]['params_sha256'][:16]}); per-rank launches {ranks[0]['launches']}",
          flush=True)

    y_procs, y_reports = launch_ranks(run_dir, "sync", [
        *pre, "NUM_UPDATES", "6", "RL.PPO.short_rollout_threshold", "0.5",
        "RL.PPO.sync_frac", "0.5"], device, env)
    ddppo_parity(torch, run_dir, pre, device, env)
    sync, _ = wait_ranks("ddppo-sync", y_procs, y_reports)
    cfg = get_config(TRAIN_EXP, [*TRAIN_OPTS, *pre], os.path.join(run_dir, "init"), "train")
    fills = [rep["sep_fill"] for rep in sync]
    if fills[0] != fills[1] or sync[0]["params_sha256"] != sync[1]["params_sha256"]:
        fail(f"ddppo-sync: the ranks executed {fills} refit rows, parameters "
             f"{'equal' if sync[0]['params_sha256'] == sync[1]['params_sha256'] else 'unequal'}")
    phase("ddppo-sync", t0, (
        f"short_rollout_threshold 0.5, sync_frac 0.5, TCPStore on MASTER_PORT + 1: both ranks "
        f"executed {fills[0]} of {cfg.RL.PPO.num_steps * cfg.RL.PPO.num_updates_per_cycle} "
        f"steps of the cycle; parameters bitwise equal"
    ))

    # preemption: SIGUSR2 to both ranks once their handlers are set, so the
    # first cycle's end saves; the relaunch resumes at update 6
    t0 = time.perf_counter()
    procs, reports = launch_ranks(run_dir, "preempt", pre, device, env)
    for r, p in enumerate(procs):
        for line in p.stdout:
            if "signal handlers set" in line:
                break
        else:
            fail(f"ddppo-preempt: rank {r} ended before it set its signal handlers")
    for p in procs:
        p.send_signal(signal.SIGUSR2)
    cut, _ = wait_ranks("ddppo-preempt", procs, reports)
    saved = os.listdir(states) if os.path.isdir(states) else []
    if [len(rep["cycle_log"]) for rep in cut] != [1, 1] or len(saved) != 1:
        fail(f"ddppo-preempt: cycles {[len(rep['cycle_log']) for rep in cut]}, states {saved}")
    snap = load_checkpoint(os.path.join(states, saved[0]))
    at = snap["extra_state"]["update_count"]
    procs, reports = launch_ranks(run_dir, "preempt", pre, device, env)
    done, outs = wait_ranks("ddppo-resume", procs, reports)
    if not all(f"resumed the interrupted train state at update {at}" in o for o in outs):
        fail("ddppo-resume: a rank did not resume the interrupted state")
    last = load_checkpoint(os.path.join(run_dir, "preempt", "data", "ckpt.1.pth"))
    if at != 6 or last["extra_state"]["update_count"] != 12 or os.listdir(states):
        fail(f"ddppo-resume: saved at update {at}, ended at "
             f"{last['extra_state']['update_count']}, states left {os.listdir(states)}")
    if done[0]["params_sha256"] != done[1]["params_sha256"]:
        fail("ddppo-resume: the ranks' final parameters differ")
    phase("ddppo-preempt", t0, (
        f"SIGUSR2 to both ranks: both exited 0 after cycle 1, rank 0 saved the interrupted "
        f"state at update {at} ({os.path.getsize(os.path.join(run_dir, 'preempt', 'data', 'ckpt.1.pth')) / 1e6:.1f} MB "
        f"checkpoint); the relaunch resumed at update {at}, finished cycle 2 at update 12, "
        f"and removed the state"
    ))
    return {k: sum(rep["launches"][k] for rep in ranks) for k in launches}


def ddppo_parity(torch, run_dir, pre, device="cuda:0", env=None):
    """Phase 8i's ddppo-parity (TF32 off): 2 ranks x 7 envs against 1 rank x
    14 from the same start (`pre`: the separators' opts), in float32 after
    one update and refit and after a whole cycle, and in float64 after one
    update and refit; fails past the gates, else prints the readings."""
    import numpy as np

    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.rl.trainer import PPOTrainer
    from move2hear_tpu_torch.utils.checkpoint import load_checkpoint

    env = env or {}
    # one update and refit is phase 9's scope, where TRAIN_DP_TOL is set;
    # its float64 pair ("update64") is the one the parameter gate holds. Two
    # float32 runs of different batch shapes can put a pre-activation within
    # rounding of zero on the other side of a ReLU, and Adam (eps 1e-5)
    # carries that into the step (ROADMAP Queue 3: one float32 reading in
    # eight failed 3e-4); float64 rounds some 1e-9 below such kinks
    t0 = time.perf_counter()
    tf32_off = {**env, "NVIDIA_TF32_OVERRIDE": "0"}
    scopes = {"update": ["NUM_UPDATES", "1", "RL.PPO.num_updates_per_cycle", "1"],
              "cycle": ["NUM_UPDATES", "6"]}
    scopes["update64"] = scopes["update"]
    runs = {}
    for scope, upd in scopes.items():
        f64 = scope.endswith("64")
        e = {**tf32_off, "M2H_TEST_FLOAT64": "1"} if f64 else tf32_off
        runs[scope] = (
            launch_ranks(run_dir, f"parity_world_{scope}", [*pre, *upd], device, e, helper=f64),
            launch_ranks(run_dir, f"parity_single_{scope}", [*pre, *upd, "NUM_PROCESSES", "14"],
                         device, e, ranks=1, helper=f64),
        )
    cfg = get_config(TRAIN_EXP, [*TRAIN_OPTS, *pre], os.path.join(run_dir, "init"), "train")
    start = {k: v.numpy() for k, v in PPOTrainer(cfg, device="cpu")._new_policy().state_dict().items()}
    readings = {}
    for scope, ((w_procs, w_reports), (s_procs, s_reports)) in runs.items():
        world, _ = wait_ranks("ddppo-parity", w_procs, w_reports)
        (single,), _ = wait_ranks("ddppo-parity", s_procs, s_reports)
        if scope.endswith("64"):
            ours, ref = world[0]["state_dict"], single["state_dict"]
            if ref["critic.fc.weight"].dtype != torch.float64:
                fail(f"ddppo-parity: the float64 runs trained in {ref['critic.fc.weight'].dtype}")
        else:
            ours, ref = (load_checkpoint(os.path.join(run_dir, f"parity_{kind}_{scope}", "data",
                                                      "ckpt.1.pth"))["state_dict"]
                         for kind in ("world", "single"))
        la, lb = (np.concatenate([np.ravel(x) for x in rep["loss_log"][0]])
                  for rep in (world[0], single))
        # relative, but for a loss below 1e-2 (the action loss of an epoch
        # starts at the mean of normalised advantages, 0 but for rounding)
        loss = float(np.max(np.abs(la - lb) / np.maximum(np.abs(lb), 1e-2)))
        dp = {k: float(np.linalg.norm(ours[k].numpy() - b.numpy())
                       / np.linalg.norm(b.numpy() - start[k]))
              for k, b in ref.items() if b.is_floating_point() and "running_" not in k
              and not np.array_equal(b.numpy(), start[k])}
        readings[scope] = (loss, sorted(dp.items(), key=lambda kv: -kv[1])[:3], len(dp))
    for scope, (loss, top, _) in readings.items():
        if not loss <= TRAIN_TOL:
            fail(f"ddppo-parity ({scope}): losses of 2 x 7 against 1 x 14 differ by {loss} "
                 f"relative (tol {TRAIN_TOL})")
    d_loss, d_top, d_n = readings["update64"]
    if not d_top[0][1] <= TRAIN_DP_TOL:
        fail(f"ddppo-parity: parameter change of {d_top[0][0]} after one float64 update and "
             f"refit differs by {d_top[0][1]} relative in norm (tol {TRAIN_DP_TOL})")
    loss, top, n = readings["update"]
    c_loss, c_top, c_n = readings["cycle"]
    phase("ddppo-parity", t0, (
        f"TF32 off, 2 ranks x 7 envs against 1 rank x 14 (losses relative, below 1e-2 "
        f"absolute over 1e-2, tol {TRAIN_TOL}): one update and refit in float64, losses "
        f"within {d_loss:.3e}, parameter change of {d_n} tensors within "
        + ", ".join(f"{v:.3e} ({k})" for k, v in d_top) + f" in norm (tol {TRAIN_DP_TOL}); "
        f"in float32, losses within {loss:.3e}, parameter change of {n} tensors within "
        + ", ".join(f"{v:.3e} ({k})" for k, v in top) + " in norm (not gated: a ReLU "
        f"kink apart); the whole cycle (6 updates and refits) in float32, losses within "
        f"{c_loss:.3e}, parameter change of {c_n} tensors within "
        + ", ".join(f"{v:.3e} ({k})" for k, v in c_top)
        + " in norm (not gated: the parts compound through 48 Adam steps and 5 collects)"
    ))


def mfu_line(info, rate, card_name):
    """MFU of a warm rate from ``mfu_info``: flops_per_env_step x env-steps/s
    over the card's dense bfloat16 tensor-core peak (BF16_PEAK_FLOPS)."""
    peak = BF16_PEAK_FLOPS.get(card_name)
    achieved = info["flops_per_env_step"] * rate
    if peak is None:
        return (f"{achieved / 1e12:.3f} TFLOP/s counted; MFU not computed: no bfloat16 peak for "
                f"{card_name!r}")
    return (f"{achieved / 1e12:.3f} TFLOP/s counted = MFU {100 * achieved / peak[0]:.4f}% of "
            f"{peak[0] / 1e12:.0f} TFLOP/s ({peak[1]})")


def print_mfu_info(label, info):
    if info is None:
        fail(f"{label}: REPORT_MFU left mfu_info None")
    print(f"{label} mfu_info: " + ", ".join(
        f"{k} {v:.6e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in info.items() if k != "method") + f"; method: {info['method']}", flush=True)


def bf16_train_phase(torch, kernels, card, run_dir, pretrained, f32_rate, device="cuda",
                     opts=(), launches=BF16_TRAIN_LAUNCHES):
    """Phase 8j: phase 8's train CLI with BF16_OPTS, then the eval CLI on
    its checkpoint. Returns (the path's launch counts, its checkpoint)."""
    on_cuda = device == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counts, ckpt, trainer = train_phase(torch, kernels, card, run_dir, label="bf16-train",
                                        device=device, opts=[*BF16_OPTS, *opts],
                                        launches=launches, pretrained=pretrained)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_cuda else float("nan")
    if trainer.final_policy.dtype != torch.bfloat16:
        fail(f"bf16-train: the policy computes in {trainer.final_policy.dtype}")
    warm = trainer.cycle_log[1]
    rate = warm["env_steps"] / warm["total"]
    print_mfu_info("bf16-train", trainer.mfu_info)
    name = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    print(f"bf16-train: set-up {trainer.setup_s:.3f} s, warm {rate:.1f} env-steps/s against phase "
          f"8's float32 {f32_rate:.1f} in this run; {mfu_line(trainer.mfu_info, rate, name)}; "
          f"peak device memory allocated {peak:.2f} GB ({card})", flush=True)
    train_eval_phase(run_dir, ckpt, device=device, opts=opts)
    return counts, ckpt


def bench_phase(torch, kernels, card, run_dir, device="cuda", opts=(), launches=BENCH_LAUNCHES,
                scene=BENCH_SCENE, label="bench-shape", stats=None):
    """Phase 8k: bench.py's default device-mode shape through the port's
    own config (no exp yaml, BENCH_OPTS) and micro-scene, 2 cycles, with
    the launch counters set to 0 just before it and read just after.
    Returns the path's launch counts. (`opts`, `launches` and `scene` let a
    rehearsal run it small on the CPU; phase 8n's fusion-bench, `label`,
    adds TPU.FUSED_CYCLE, under which REPORT_MFU must leave mfu_info
    None.) `stats`, a dict, receives the warm rate and the peak memory."""
    import numpy as np

    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.env.micro_scene import build_micro_scene
    from move2hear_tpu_torch.rl.trainer import PPOTrainer

    t0 = time.perf_counter()
    cfg = get_config(None, [*BENCH_OPTS, *opts], run_dir, "train")
    bundle = build_micro_scene(**scene)
    on_cuda = device == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    trainer = PPOTrainer(cfg, bundle=bundle, device=device)
    trainer.train()
    if on_cuda:
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_cuda else float("nan")
    if counts != launches:
        fail(f"{label}-path kernel launches {counts}, expected {launches}")
    if trainer._rir_mode != "dense" or len(trainer.cycle_log) != 2:
        fail(f"{label}: route {trainer._rir_mode}, {len(trainer.cycle_log)} cycles")
    fused = bool(cfg.TPU.FUSED_CYCLE)
    for i, c in enumerate(trainer.cycle_log):
        phase(label, t0, (
            f"cycle {i} ({'cold' + ', FLOPs counted' * (not fused) if i == 0 else 'warm'}): "
            f"{c['env_steps']} "
            f"env-steps in {c['total']:.3f} s = {c['env_steps'] / c['total']:.1f} env-steps/s; "
            f"collect {c['collect']:.3f} s, policy update {c['update']:.3f} s, refit "
            f"{c['refit']:.3f} s ({card})"
        ))
    for i, (pol, sep) in enumerate(trainer.loss_log):
        if not (np.isfinite(pol).all() and np.isfinite(sep).all()):
            fail(f"{label} cycle {i}: losses not finite: pol {pol.tolist()} sep {sep.tolist()}")
    warm = trainer.cycle_log[1]
    rate = warm["env_steps"] / warm["total"]
    name = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    if fused:
        if trainer.mfu_info is not None:
            fail(f"{label}: REPORT_MFU counted FLOPs under TPU.FUSED_CYCLE")
        mfu = "REPORT_MFU skipped under TPU.FUSED_CYCLE, as the JAX package's probe"
    else:
        print_mfu_info(label, trainer.mfu_info)
        mfu = mfu_line(trainer.mfu_info, rate, name)
    print(f"{label}: {cfg.NUM_PROCESSES} envs, hidden {cfg.RL.PPO.hidden_size}, bfloat16"
          f"{', TPU.FUSED_CYCLE' * fused}; set-up {trainer.setup_s:.3f} s, warm {rate:.1f} "
          f"env-steps/s, end to end "
          f"{sum(c['env_steps'] for c in trainer.cycle_log) / wall:.1f} over {wall:.3f} s; "
          f"{mfu}; peak device memory allocated {peak:.2f} GB; "
          f"{label}-path launches: {counts} ({card})", flush=True)
    if stats is not None:
        stats.update(rate=rate, peak_gb=peak)
    return counts


def fusion_phase(torch, kernels, card, run_dir, pretrained, f32_rate, device="cuda", opts=(),
                 launches=TRAIN_LAUNCHES, forward_opts=None):
    """Phase 8n: phase 8's train CLI with TPU.FUSED_CYCLE and then with
    TPU.PAIRWISE_FUSION, 2 cycles each from phase 6's separators: the same
    loops under the JAX package's fusion routing (the rollouts store the
    frames; no pose bank, sync, sub-banks or FLOP count), each with phase
    8's launches, its warm rate beside phase 8's, its update seconds and its
    peak memory, and the eval CLI on its checkpoint; then
    fusion_forward_check. Returns the launch counts by path. (`device`,
    `opts`, `launches` and `forward_opts`, the forward check's own opts, let
    a rehearsal run it small on the CPU.)"""
    by_path = {}
    on_cuda = device == "cuda"
    for knob, label in FUSION_ROUTES:
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        counts, ckpt, trainer = train_phase(
            torch, kernels, card, os.path.join(run_dir, label), label=label, device=device,
            opts=[f"TPU.{knob}", "True", *opts], launches=launches, pretrained=pretrained)
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_cuda else float("nan")
        if trainer._pose_obs or trainer._rir_mode != "dense" or trainer.mfu_info is not None:
            fail(f"{label}: pose bank {trainer._pose_obs}, route {trainer._rir_mode}, "
                 f"mfu_info {trainer.mfu_info}")
        warm = trainer.cycle_log[1]
        print(f"{label}: TPU.{knob} True, frames in the rollouts: warm "
              f"{warm['env_steps'] / warm['total']:.1f} env-steps/s against phase 8's "
              f"{f32_rate:.1f} in this run; policy update {warm['update']:.3f} s of the warm "
              f"cycle; peak device memory allocated {peak:.2f} GB ({card})", flush=True)
        del trainer
        train_eval_phase(run_dir, ckpt, device=device, opts=opts, label=label)
        by_path[label.replace("-", "_")] = counts
    fusion_forward_check(torch, run_dir, pretrained, device=device,
                         opts=opts if forward_opts is None else forward_opts)
    return by_path


def fusion_forward_check(torch, run_dir, pretrained, device="cuda", opts=()):
    """The end of phase 8n: the policy update's forward (values, action
    log-probs, entropy) over the first collected rollout, before any
    optimizer step, on the default route (pose indices and the pose bank)
    and under TPU.FUSED_CYCLE (the stored frames), TF32 off: the same
    actions, and each output within FUSION_FORWARD_TOL of the other,
    relative to its largest magnitude."""
    import move2hear_tpu_torch.rl.trainer as rt
    from move2hear_tpu_torch.main import main as port_main
    from move2hear_tpu_torch.rl.ppo import rollout_forward

    t0 = time.perf_counter()
    seen = {}
    make = rt.make_update_pol

    def recording(policy, cfg, n, pose_bank=False, **kwargs):
        update = make(policy, cfg, n, pose_bank=pose_bank, **kwargs)

        def run(state, rollouts, *args, banks=None, **kw):
            if pose_bank not in seen:
                with torch.no_grad():
                    out = rollout_forward(policy, rollouts, banks, pose_bank)
                seen[pose_bank] = ([t.double().cpu() for t in out], rollouts["actions"].cpu())
            return update(state, rollouts, *args, banks=banks, **kw)
        return run

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rt.make_update_pol = recording
    try:
        for knob in ("", "TPU.FUSED_CYCLE"):
            port_main(["--run-type", "train", "--exp-config", TRAIN_EXP, "--model-dir",
                       os.path.join(run_dir, "fusion_forward", knob or "default"),
                       "--device", device, "NUM_UPDATES", "1", "RL.PPO.num_updates_per_cycle",
                       "1", "RL.PPO.pretrained_passive_separators_ckpt", pretrained,
                       *([knob, "True"] if knob else []), *opts])
    finally:
        rt.make_update_pol = make
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if set(seen) != {True, False}:
        fail(f"fusion-forward: the runs took pose_bank {sorted(seen)}, expected both")
    (pose, pose_acts), (frames, frame_acts) = seen[True], seen[False]
    if not torch.equal(pose_acts, frame_acts):
        fail("fusion-forward: the two routes' collects sampled other actions")
    errs = {}
    for name, a, b in zip(("values", "action log-probs", "entropy"), frames, pose):
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        if not errs[name] <= FUSION_FORWARD_TOL:
            fail(f"fusion-forward: {name} over the frames and over the pose bank differ by "
                 f"{errs[name]} relative (tol {FUSION_FORWARD_TOL})")
    phase("fusion-forward", t0, (
        f"TF32 off, the update's forward over a rollout of {tuple(pose_acts.shape[:2])} "
        f"(steps, envs) before any optimizer step: over the stored frames (TPU.FUSED_CYCLE) "
        f"against over the pose bank (default route), equal actions, "
        + ", ".join(f"{k} within {v:.3e}" for k, v in errs.items())
        + f" of the largest (tol {FUSION_FORWARD_TOL})"
    ))


def bf16_sub_phase(torch, run_dir, device="cuda", opts=(), fixture=SCALE_PARITY_FIXTURE,
                   scale=SCALE_FIXTURE):
    """Phase 8l: TPU.SUB_BANK_DTYPE bfloat16 on the scale-parity fixture:
    the slab's gather against the dense bank rounded to bfloat16, and one
    cycle's losses against the float32 slab's; then the slab the gate
    reckons for the scale fixture at 2 bytes a sample. (`opts`, `fixture`
    and `scale` let a rehearsal run it small on the CPU.)"""
    import dataclasses

    import numpy as np

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.env.micro_scene import build_scale_fixture
    from move2hear_tpu_torch.env.sub_bank import RirSubBank, row_bytes
    from move2hear_tpu_torch.rl.trainer import PPOTrainer

    t0 = time.perf_counter()
    bundle = build_scale_fixture(**fixture)
    dense = de.build_device_bundle(bundle, device, rir_mode="dense")
    sub_dev = de.build_device_bundle(bundle, device, rir_mode="sub")
    order = de.make_order_table(14, len(bundle.episodes), SEED)
    sub = RirSubBank(bundle.scenes, bundle.audio_db, sub_dev.episodes.scene_idx.cpu().numpy(),
                     sub_dev.episodes.sources.cpu().numpy(), order, 20, 20,
                     v_pad=int(sub_dev.scene.positions.shape[1]), device=device,
                     dtype=torch.bfloat16)
    slab, table = sub.rollout_inputs()
    sub_dev = dataclasses.replace(sub_dev, rir_sub_bank=slab, ep_src_row=table)
    obs = de.observe(dense.episodes, de.env_reset_all(dense.scene, dense.episodes,
                                                      torch.as_tensor(order, device=device)))
    got = de.gather_sensors(sub_dev, obs)["rirs"]
    want = de.gather_sensors(dense, obs)["rirs"]
    if got.dtype != torch.float32 or not torch.equal(got, want.to(torch.bfloat16).float()):
        fail("bf16-sub: the bfloat16 slab's gather is not the dense bank rounded to bfloat16")
    phase("bf16-sub", t0, f"slab {tuple(slab.shape)} {slab.dtype}, {sub.row_bytes / 1e6:.2f} MB "
                          f"a row: the gather is bitwise the dense bank rounded to bfloat16")
    del dense, sub_dev, sub, slab
    losses = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = get_config(TRAIN_EXP, ["NUM_UPDATES", "6", "RL.PPO.pretrained_passive_separators_ckpt",
                                     "", "TPU.RIR_MODE", "sub", "TPU.SUB_BANK_DTYPE", dtype,
                                     *opts],
                         os.path.join(run_dir, dtype), "train")
        trainer = PPOTrainer(cfg, bundle=bundle, device=device)
        trainer.train()
        losses[dtype] = [np.concatenate([p.ravel(), s.ravel()]) for p, s in trainer.loss_log][0]
        if trainer._sub_bank.dtype != getattr(torch, dtype):
            fail(f"bf16-sub: a {trainer._sub_bank.dtype} slab under SUB_BANK_DTYPE {dtype}")
        phase("bf16-sub", t0, f"one cycle on the {dtype} slab: losses {losses[dtype].tolist()}")
        del trainer
    a, b = losses["bfloat16"], losses["float32"]
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-2)))
    if not rel <= BF16_SUB_LOSS_REL:
        fail(f"bf16-sub: losses part from the float32 slab's by {rel} > {BF16_SUB_LOSS_REL}")
    big = build_scale_fixture(**scale)
    reckoner = PPOTrainer(get_config(TRAIN_EXP, ["TPU.SUB_BANK_DTYPE", "bfloat16", *opts],
                                     os.path.join(run_dir, "reckon"), "train"), bundle=big,
                          device=device)
    v = max(s.num_nodes for s in big.scenes.values())
    rows = reckoner.sub_bank_rows(big, v)
    print(f"bf16-sub: losses within {rel:.3e} of the float32 slab's (relative, or absolute below "
          f"1e-2; tol {BF16_SUB_LOSS_REL}); the scale fixture's slab at 2 bytes a sample: {rows} "
          f"rows x {row_bytes(v, big.audio_db.rir_length, 2) / 1e6:.1f} MB = "
          f"{rows * row_bytes(v, big.audio_db.rir_length, 2) / 1e9:.2f} GB (float32: "
          f"{rows * row_bytes(v, big.audio_db.rir_length, 4) / 1e9:.2f} GB for as many rows; "
          f"reckoned, not allocated)", flush=True)


def bf16_parity_phase(torch, devices=("cuda", "cpu"), b=4, hid=512):
    """Phase 8m's bf16-parity: the bfloat16 policy's separator chain and
    deterministic act on the card against the CPU's bfloat16, under the CPU
    tests' discriminator with the CPU's float32 as the yardstick, at full
    width. Each stage after the first takes the CPU bfloat16 chain's inputs
    on both sides (tests/test_torch_bf16_models.py), so each is weighed on
    its own rounding. (`devices` and `hid` let a rehearsal run it on the
    CPU alone.)"""
    import numpy as np

    from move2hear_tpu_torch.models import Move2HearPolicy

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    inp = {
        "rgb": rng.integers(0, 256, (b, 128, 128, 3)).astype(np.uint8),
        "depth": rng.uniform(0, 1, (b, 128, 128, 1)).astype(np.float32),
        "mixed_bin_audio_mag": np.abs(rng.standard_normal((b, 512, 32, 2))).astype(np.float32),
        "target_class": rng.integers(0, 10, (b, 1)).astype(np.int64),
    }
    hidden = rng.standard_normal((b, hid)).astype(np.float32)
    masks = (rng.uniform(size=(b, 1)) > 0.3).astype(np.float32)
    prev = rng.standard_normal((b, 512, 32, 1)).astype(np.float32)
    torch.manual_seed(SEED + 3)
    weights = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True).state_dict()

    def run(device, dtype, feed=None):
        """The chain's outputs; with `feed` (the CPU's bfloat16 outputs) each
        stage after the first takes feed's inputs, in the run's dtype."""
        policy = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True, dtype=dtype)
        policy.load_state_dict(weights)
        policy = policy.to(device).eval()
        on = {k: torch.from_numpy(v).to(device) for k, v in inp.items()}
        fed = None if feed is None else {
            k: torch.from_numpy(feed[k]).to(device, torch.bfloat16).to(dtype)
            for k in ("binSep masks", "bin2mono", "acoustic mem")}
        with torch.no_grad():
            pm = policy.get_binSepMasks(on)
            pm_in = pm if fed is None else fed["binSep masks"]
            mono = policy.convert_bin2mono(pm_in, on["mixed_bin_audio_mag"])
            mono_in = mono if fed is None else fed["bin2mono"]
            mem = policy.get_monoFromMem(mono_in, torch.from_numpy(prev).to(device))
            mem_in = mem if fed is None else fed["acoustic mem"]
            act = policy.act(on, torch.from_numpy(hidden).to(device),
                             torch.from_numpy(masks).to(device), pm_in, mono_in, mem_in,
                             deterministic=True)
        out = {"binSep masks": pm, "bin2mono": mono, "acoustic mem": mem, "value": act.value,
               "hidden": act.hidden, "probs": act.probs}
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    cpu = run(devices[1], torch.bfloat16)
    card, ref = run(devices[0], torch.bfloat16, cpu), run(devices[1], torch.float32, cpu)
    worst = []
    for k in card:
        port_err = float(np.abs(card[k] - cpu[k]).mean())
        dtype_err = float(np.abs(cpu[k] - ref[k]).mean())
        ratio = dtype_err / max(port_err, 1e-30)
        top = float(np.abs(card[k] - cpu[k]).max())
        floor = BF16_MAX_ULPS * 2.0**-7 * float(np.abs(ref[k]).max())
        if not (ratio >= BF16_RATIO and top <= floor):
            fail(f"bf16-parity {k}: mean |card - cpu| {port_err:.3e} is {ratio:.2f}x below mean "
                 f"|cpu bf16 - cpu f32| {dtype_err:.3e} (need {BF16_RATIO}); max {top:.3e} "
                 f"(floor {floor:.3e})")
        worst.append(f"{k} {ratio:.1f}x (max {top:.2e})")
    phase("bf16-parity", t0, f"{devices[0]} bf16 vs {devices[1]} bf16, {devices[1]} float32 the "
                             f"yardstick, hidden {hid}, B={b}: mean-error ratios " + ", ".join(worst))


def bf16_host_eval_phase(torch, kernels, card, run_dir, ckpt, device="cuda", opts=(),
                         episodes=2, launches=BF16_HOST_EVAL_LAUNCHES):
    """Phase 8m's host eval: the eval CLI with configs/test/nearTarget.yaml
    on 8j's checkpoint, `episodes` episodes (below DEVICE_EVAL_MIN_EPISODES:
    the host evaluator) in bfloat16, with the launch counters set to 0 just
    before it and read just after. Returns its launch counts."""
    from move2hear_tpu_torch.main import main as port_main

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    ev = port_main(["--run-type", "eval", "--exp-config",
                    os.path.join(REPO, "configs", "test", "nearTarget.yaml"), "--model-dir",
                    os.path.join(run_dir, "bf16_host_eval"), "--device", device,
                    "EVAL_CKPT_PATH_DIR", ckpt, "EVAL_EPISODE_COUNT", str(episodes),
                    "TPU.DEVICE_EVAL_MIN_EPISODES", str(episodes + 1),
                    "TPU.COMPUTE_DTYPE", "bfloat16", *opts])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = path_counts(kernels, launches)
    agg, tm = ev.last_eval
    if ev._eval_route != "host" or counts != launches:
        fail(f"bf16-host-eval: the {ev._eval_route} evaluator, launches {counts}, expected "
             f"{launches}")
    for k in ("mono_l2_last", "mem_l2_last", "bin_l2_all"):
        if not all(math.isfinite(v) for v in agg[k].values()):
            fail(f"bf16-host-eval: {k} not finite: {agg[k]}")
    phase("bf16-host-eval", t0, (
        f"{tm['episodes']} episodes, {tm['env_steps'] / tm['loop_s']:.1f} env-steps/s over the "
        f"episode loop; mono_l2_last {agg['mono_l2_last']['mean']:.6f}, mem_l2_last "
        f"{agg['mem_l2_last']['mean']:.6f}; bf16-host-eval-path launches: {counts} ({card})"
    ))
    return counts


def graph_phase(torch, card, run_dir, built, device="cuda", fixture=GRAPH_FIXTURE):
    """Phase 8o: the C++ graph walker (built in phase 2: `built` is its
    compiler, version and seconds) on GRAPH_FIXTURE's graphs, written by
    env/layout.py: ``GraphScene.from_files``, the far-target episode checks
    (``generate_episodes``) and ``build_device_scene`` timed on the walker
    and on the Python path (the same scenes without it, build_device_scene's
    NATIVE_MIN_NODES raised above V); the device tables, the episodes and
    ``forward_neighbor`` at every node and 8 orientations must be equal.
    (`device` and `fixture` let a rehearsal run it small on the CPU.)"""
    import dataclasses

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.env.episodes import generate_episodes
    from move2hear_tpu_torch.env.layout import write_scene_graph
    from move2hear_tpu_torch.env.micro_scene import DEFAULT_SOUNDS
    from move2hear_tpu_torch.env.scene import GraphScene

    t0 = time.perf_counter()
    meta = os.path.join(run_dir, "graphs")
    names = [f"graph{i:02d}" for i in range(fixture["num_scenes"])]
    nbytes = sum(write_scene_graph(meta, GraphScene.grid(n, fixture["rows"], fixture["cols"]))
                 for n in names)
    v = fixture["rows"] * fixture["cols"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def run(walker: bool):
        secs = {}
        t = time.perf_counter()
        scenes = {n: GraphScene.from_files(meta, n) for n in names}
        secs["from_files"] = time.perf_counter() - t
        if not walker:  # the same scenes on the Python path
            scenes = {n: GraphScene(n, s.positions, s.neighbors, s.grid_size)
                      for n, s in scenes.items()}
        t = time.perf_counter()
        eps = [generate_episodes(scenes[n], DEFAULT_SOUNDS, fixture["episodes"],
                                 near_target=False, seed=SEED + i, esc_sounds=("esc",)).episodes
               for i, n in enumerate(names)]
        secs["episode checks"] = time.perf_counter() - t
        limit = de.NATIVE_MIN_NODES
        de.NATIVE_MIN_NODES = limit if walker else v + 1
        try:
            t = time.perf_counter()
            dev = de.build_device_scene(scenes, device)
            sync()
            secs["build_device_scene"] = time.perf_counter() - t
        finally:
            de.NATIVE_MIN_NODES = limit
        if any((s._native is not None) != walker for s in scenes.values()):
            fail(f"graph-walker: the {'walker' if walker else 'Python'} route's scenes "
                 f"{'lack' if walker else 'carry'} the walker")
        return scenes, eps, dev, secs

    phase("graph-walker", t0, f"{len(names)} scenes of V = {v} written ({nbytes / 1e6:.3f} MB "
                              f"of points.txt + graph.pkl); walker built by {built[0]} "
                              f"({built[1]}) in {built[2]:.3f} s in phase 2")
    scenes, eps, dev, fast = run(walker=True)
    py_scenes, py_eps, py_dev, slow = run(walker=False)
    for field in dataclasses.fields(dev):
        a, b = getattr(dev, field.name), getattr(py_dev, field.name)
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"graph-walker: build_device_scene's {field.name} differs between the walker "
                 "and the Python path")
    if dev.dist.dtype != torch.int64 or int(dev.dist.min()) < -1:
        fail(f"graph-walker: dist {dev.dist.dtype}, min {int(dev.dist.min())}")
    if [[dataclasses.astuple(e) for e in es] for es in eps] != \
            [[dataclasses.astuple(e) for e in es] for es in py_eps]:
        fail("graph-walker: the far-target episodes differ between the walker and the Python path")
    moves = 0
    for n in names:
        for node in range(v):
            for orientation in range(0, 360, 45):
                a = scenes[n].forward_neighbor(node, orientation)
                if a != py_scenes[n].forward_neighbor(node, orientation):
                    fail(f"graph-walker: {n} forward_neighbor({node}, {orientation}) differs")
                moves += a != node
    total = {k: sum(d.values()) for k, d in (("walker", fast), ("python", slow))}
    phase("graph-walker", t0, (
        f"dist {tuple(dev.dist.shape)} and every other table equal, {sum(map(len, eps))} "
        f"far-target episodes equal, forward_neighbor equal at {len(names) * v * 8} (node, "
        f"orientation) pairs ({moves} moves); host seconds, walker against Python: " + ", ".join(
            f"{k} {fast[k]:.4f} / {slow[k]:.4f}" for k in fast)
        + f"; in all {total['walker']:.4f} / {total['python']:.4f} s = "
        f"{total['python'] / total['walker']:.1f}x ({card})"
    ))


def host_phases(torch, kernels, card, run_dir, pretrained, switch_ckpt):
    """Phases 8e-8h in the run directory; the fixture is removed after them.
    Returns the host paths' launch counts by path."""
    layout = os.path.join(run_dir, "layout")
    try:
        fixture_opts = host_fixture_phase(layout)
        train_counts, ckpt = host_train_phase(torch, kernels, card, os.path.join(run_dir, "host"),
                                              fixture_opts, pretrained=pretrained)
        eval_counts, switch_counts = host_eval_phase(
            torch, kernels, card, os.path.join(run_dir, "host_eval"), fixture_opts, ckpt,
            switch_ckpt)
        host_parity_phase(torch, os.path.join(run_dir, "host_parity"), fixture_opts, ckpt,
                          card=card)
    finally:
        shutil.rmtree(layout, ignore_errors=True)
    return {"host_train": train_counts, "host_eval": eval_counts,
            "host_switch_eval": switch_counts}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "move2hear_tpu_torch")):
        fail(f"no move2hear_tpu_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    from move2hear_tpu_torch.ops import build, kernels

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    phase("card", t0, (
        f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; yaml importable: {has_yaml}"
    ))

    t0 = time.perf_counter()
    for name in build.SOURCES:
        lib = build.library_path(name)
        if os.path.exists(lib):
            os.remove(lib)  # always build from the checkout's sources
    secs = build.build_all()
    for name in build.SIGNATURES:
        build.load(name)
    for name in build.SOURCES:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    phase("build", t0, f"{len(build.SOURCES)} CUDA sources built by nvcc in {secs:.2f} s, "
                       f"{len(build.SIGNATURES)} launchers bound")
    t0 = time.perf_counter()
    walker = walker_build()
    phase("build", t0, f"the C++ graph walker (move2hear_tpu_torch/native/m2h_native.cc) built "
                       f"by {walker[0]} ({walker[1]}) in {walker[2]:.3f} s")

    rows = time_phase(torch, kernels, check_phase(torch, kernels))
    run_dir = os.path.join(REPO, "_smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        launches = slice_phase(torch, kernels, card, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    parity_phase(torch)
    os.makedirs(run_dir)
    try:
        pre_stats, bf16_pre_stats = {}, {}
        pre_launches, pre_ckpts = pretrain_phase(torch, kernels, card,
                                                 os.path.join(run_dir, "pretrain"),
                                                 stats=pre_stats)
        pre_eval_launches = pretrain_eval_phase(torch, kernels, pre_ckpts, run_dir)
        pretrained = os.path.join(pre_ckpts, "best_ckpt_nonoverlapping_val.pth")
        train_launches, near_ckpt, near_trainer = train_phase(torch, kernels, card, run_dir,
                                                              pretrained=pretrained)
        f32_warm = near_trainer.cycle_log[1]
        del near_trainer
        train_eval_phase(run_dir, near_ckpt)
        far_train_launches, far_ckpt, far_trainer = train_phase(
            torch, kernels, card, os.path.join(run_dir, "far"), label="far-train",
            exp=FAR_TRAIN_EXP, launches=FAR_TRAIN_LAUNCHES, pretrained=pretrained)
        require_nav_rewards(far_trainer)
        del far_trainer
        far_eval_launches = far_eval_phase(torch, kernels, card, run_dir, far_ckpt, near_ckpt)
        parity_phase(torch, switch=True)
        scale_launches = scale_train_phase(torch, kernels, card, os.path.join(run_dir, "scale"),
                                           pretrained=pretrained)
        scale_parity_phase(torch, os.path.join(run_dir, "scale_parity"))
        host_launches = host_phases(torch, kernels, card, run_dir, pretrained,
                                    os.path.join(run_dir, "switch.pth"))
        ddppo_launches = ddppo_phase(torch, card, os.path.join(run_dir, "ddppo"), pretrained)
        bf16_launches, bf16_ckpt = bf16_train_phase(
            torch, kernels, card, os.path.join(run_dir, "bf16"), pretrained,
            f32_warm["env_steps"] / f32_warm["total"])
        bench_stats = {}
        bench_launches = bench_phase(torch, kernels, card, os.path.join(run_dir, "bench"),
                                     stats=bench_stats)
        bf16_sub_phase(torch, os.path.join(run_dir, "bf16_sub"))
        bf16_pre_launches, _ = pretrain_phase(
            torch, kernels, card, os.path.join(run_dir, "bf16_pretrain"),
            opts=["TPU.COMPUTE_DTYPE", "bfloat16"], launches=BF16_PRETRAIN_LAUNCHES,
            label="bf16-pretrain", epochs=BF16_PRETRAIN_EPOCHS, stats=bf16_pre_stats)
        print(f"bf16-pretrain: warm {bf16_pre_stats['warm_rate']:.1f} samples/s against phase 6's "
              f"float32 {pre_stats['warm_rate']:.1f} in this run ({card})", flush=True)
        bf16_parity_phase(torch)
        bf16_host_eval_launches = bf16_host_eval_phase(torch, kernels, card, run_dir, bf16_ckpt)
        fusion_launches = fusion_phase(torch, kernels, card, run_dir, pretrained,
                                       f32_warm["env_steps"] / f32_warm["total"])
        fused_bench = {}
        fusion_launches["fusion_bench"] = bench_phase(
            torch, kernels, card, os.path.join(run_dir, "fusion_bench"),
            opts=["TPU.FUSED_CYCLE", "True"], label="fusion-bench", stats=fused_bench)
        print(f"fusion-bench: warm {fused_bench['rate']:.1f} env-steps/s against phase 8k's "
              f"{bench_stats['rate']:.1f} in this run; peak device memory allocated "
              f"{fused_bench['peak_gb']:.2f} GB against {bench_stats['peak_gb']:.2f} ({card})",
              flush=True)
        graph_phase(torch, card, run_dir, walker)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    train_parity_phase(torch)
    pretrain_parity_phase(torch)

    by_path = {"eval": launches, "train": train_launches, "pretrain": pre_launches,
               "pretrain_eval": pre_eval_launches, "far_train": far_train_launches,
               "far_eval": far_eval_launches, "scale_train": scale_launches, **host_launches,
               "ddppo_train": ddppo_launches, "bf16_train": bf16_launches,
               "bench_shape": bench_launches, "bf16_pretrain": bf16_pre_launches,
               "bf16_host_eval": bf16_host_eval_launches, **fusion_launches}
    for name, row in rows.items():
        # the launches of every path's runs (path_counts failed any path
        # that launched a kernel it does not name)
        row["launches_by_path"] = {path: counts.get(name, 0) for path, counts in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

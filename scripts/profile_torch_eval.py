#!/usr/bin/env python3
"""Where the time goes in one batch of the PyTorch port's device evaluator.

    python scripts/profile_torch_eval.py [--exp-config configs/test/nearTarget.yaml]

On an NVIDIA GPU: reads the experiment config with the port's `get_config`,
builds a policy of that config with weights from its SEED, and sets the
evaluator up exactly as ``--run-type eval`` does (`setup_device_eval`).
Runs the first batch of envs over the episode horizon once to warm up, once
unprofiled (the loop time), then under torch.profiler. Prints the card, the
device's busy share of the unprofiled loop (summed kernel and copy time over
loop time) and device time by kernel family with its event count (for the
two hand-written kernels, their launches and time per launch on the path),
and one JSON line with the same numbers. Fails without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (  # first match wins; names are CUDA kernel names
    ("masked_mix_slice16_bwd", ("masked_mix_slice16_bwd",)),
    ("masked_mix_slice16", ("masked_mix_slice16",)),
    ("overlap_add", ("overlap_add",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("optimizer", ("multi_tensor", "adam")),
    ("conv/gemm", ("conv", "gemm", "sm90", "cudnn", "cutlass", "xmma", "implicit", "winograd")),
    ("fft", ("fft", "radix", "regular_fft", "vector_fft")),
    ("reduce", ("reduce",)),
    ("index/copy", ("index", "gather", "scatter", "copy", "cat", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def bucket(name: str) -> str:
    low = name.lower()
    for label, keys in BUCKETS:
        if any(k in low for k in keys):
            return label
    return "other"


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--exp-config", default=os.path.join(REPO, "configs", "test", "nearTarget.yaml"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_eval: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.eval.device_evaluator import setup_device_eval
    from move2hear_tpu_torch.models import Move2HearPolicy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    # nothing is written: MODEL_DIR only names the (unused) output paths
    cfg = get_config(args.exp_config, [], os.path.join(REPO, "_profile_run"), "eval")
    torch.manual_seed(cfg.SEED)
    policy = Move2HearPolicy(
        num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS), hidden_size=cfg.RL.PPO.hidden_size,
        extra_rgb=cfg.EXTRA_RGB, extra_depth=cfg.EXTRA_DEPTH, use_ddppo=cfg.RL.PPO.use_ddppo,
    )
    setup = setup_device_eval(cfg, {"state_dict": policy.state_dict()}, device="cuda")
    order = torch.arange(setup.n_envs, device="cuda")[:, None]

    def run():
        with torch.inference_mode():
            state = de.env_reset_all(setup.dev.scene, setup.dev.episodes, order)
            _, per_env, _ = setup.eval_fn(setup.dev, state, setup.generator)
        return per_env["mono_l2_last"].cpu()

    run()  # warm-up: cuFFT plans, cuDNN algorithm choice, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    loop_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    per_bucket, per_bucket_n, total_us, n_events = {}, {}, 0.0, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        if us <= 0:
            continue
        n_events += 1
        total_us += us
        b = bucket(evt.name)
        per_bucket[b] = per_bucket.get(b, 0.0) + us
        per_bucket_n[b] = per_bucket_n.get(b, 0) + 1
    env_steps = setup.n_envs * setup.max_steps
    busy = total_us * 1e-6 / loop_s
    print(card)
    print(f"{args.exp_config}: {setup.n_envs} envs x {setup.max_steps} steps, hidden "
          f"{cfg.RL.PPO.hidden_size}, deterministic {cfg.RL.PPO.deterministic_eval}")
    print(f"loop {loop_s:.4f} s for {env_steps} env-steps ({env_steps / loop_s:.1f} "
          f"env-steps/s); device time {total_us / 1e3:.2f} ms in {n_events} events "
          f"= busy {100 * busy:.1f}% of the unprofiled loop")
    for b, us in sorted(per_bucket.items(), key=lambda kv: -kv[1]):
        print(f"  {b:20s} {us / 1e3:9.3f} ms  {100 * us / max(total_us, 1e-9):5.1f}%  "
              f"{per_bucket_n[b]} events, {us / per_bucket_n[b]:.3f} us each")
    print(json.dumps({
        "card": card, "env_steps": env_steps, "loop_s": loop_s,
        "device_ms": total_us / 1e3, "busy_share": busy,
        "buckets_ms": {b: us / 1e3 for b, us in per_bucket.items()},
        "buckets_events": per_bucket_n,
    }))


if __name__ == "__main__":
    main()

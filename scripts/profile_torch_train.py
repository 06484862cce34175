#!/usr/bin/env python3
"""Where the time goes in one warm training cycle of the PyTorch port.

    python scripts/profile_torch_train.py [--exp-config configs/train/nearTarget.yaml] [--cycles 3]

On an NVIDIA GPU: runs ``--run-type train`` of the experiment config at
full width from seeded random weights (no passive-pretrain checkpoint) for
`--cycles` cycles, the last under torch.profiler. Prints the card, the
phase seconds of the last unprofiled cycle (collect, policy update, refit;
the trainer's CUDA-event marks), the device's busy share of that cycle
(the profiled cycle's summed kernel and copy time over the unprofiled
cycle's wall time), device time by kernel family with its event count (for
the hand-written kernels, their launches and time per launch on the path),
and one JSON line with the same numbers. Checkpoints go to a scratch
folder in the checkout, removed at the end. The profiler starts when the
last cycle's first collect is called and stops when its refit returns
(each after a device synchronize, in wrappers this script puts around the
trainer's collect and refit; the trainer itself is unchanged). Fails
without a GPU.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--exp-config", default=os.path.join(REPO, "configs", "train", "nearTarget.yaml"))
    ap.add_argument("--cycles", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs an NVIDIA GPU")
    if args.cycles < 3:
        sys.exit("profile_torch_train: needs 3 cycles or more (cold, warm, profiled)")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from profile_torch_eval import bucket

    import move2hear_tpu_torch.rl.trainer as trainer_mod
    from move2hear_tpu_torch.config import get_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    run_dir = os.path.join(REPO, "_profile_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    probe = get_config(args.exp_config, [], run_dir, "train")
    cycle = probe.RL.PPO.num_updates_per_cycle
    cfg = get_config(args.exp_config, [
        "NUM_UPDATES", str(args.cycles * cycle),
        "RL.PPO.pretrained_passive_separators_ckpt", "",
    ], run_dir, "train")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)

    calls = {"collect": 0, "refit": 0}
    make_collect, make_refit = trainer_mod.make_collect, trainer_mod.make_update_sep_from_slabs

    def profiled_make_collect(*a, **kw):
        collect = make_collect(*a, **kw)

        def wrapped(*ca, **ckw):
            if calls["collect"] == (args.cycles - 1) * cycle:
                torch.cuda.synchronize()
                prof.start()
            calls["collect"] += 1
            return collect(*ca, **ckw)

        return wrapped

    def profiled_make_refit(*a, **kw):
        refit = make_refit(*a, **kw)

        def wrapped(*ra, **rkw):
            out = refit(*ra, **rkw)
            calls["refit"] += 1
            if calls["refit"] == args.cycles:
                torch.cuda.synchronize()
                prof.stop()
            return out

        return wrapped

    trainer_mod.make_collect = profiled_make_collect
    trainer_mod.make_update_sep_from_slabs = profiled_make_refit
    trainer = trainer_mod.PPOTrainer(cfg, device="cuda")
    try:
        trainer.train()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

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
    warm = trainer.cycle_log[-2]
    busy = total_us * 1e-6 / warm["total"]
    print(card)
    print(f"{args.exp_config}: {cfg.NUM_PROCESSES} envs x {cfg.RL.PPO.num_steps} steps x "
          f"{cycle} updates a cycle, hidden {cfg.RL.PPO.hidden_size}, ppo_epoch "
          f"{cfg.RL.PPO.ppo_epoch}; set-up {trainer.setup_s:.3f} s")
    print(f"warm cycle {warm['total']:.4f} s for {warm['env_steps']} env-steps "
          f"({warm['env_steps'] / warm['total']:.1f} env-steps/s): collect {warm['collect']:.4f} s, "
          f"policy update {warm['update']:.4f} s, refit {warm['refit']:.4f} s")
    print(f"profiled cycle: device time {total_us / 1e3:.2f} ms in {n_events} events = busy "
          f"{100 * busy:.1f}% of the warm cycle")
    for b, us in sorted(per_bucket.items(), key=lambda kv: -kv[1]):
        print(f"  {b:20s} {us / 1e3:9.3f} ms  {100 * us / max(total_us, 1e-9):5.1f}%  "
              f"{per_bucket_n[b]} events, {us / per_bucket_n[b]:.3f} us each")
    print(json.dumps({
        "card": card, "warm_cycle": warm, "setup_s": trainer.setup_s,
        "cycles": trainer.cycle_log, "device_ms": total_us / 1e3, "busy_share": busy,
        "buckets_ms": {b: us / 1e3 for b, us in per_bucket.items()},
        "buckets_events": per_bucket_n,
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time goes in the warm epochs of the PyTorch port's passive
pretrain.

    python scripts/profile_torch_pretrain.py [--epochs 20]

On an NVIDIA GPU: runs ``--run-type train`` of configs/pretrain_passive.yaml
at full width (the four U-Nets, BATCH_SIZE 64, the trainer's synthetic
sources: 4 train steps and 2 validation batches an epoch) from weights drawn
from SEED for `--epochs` epochs, the last half of them under
torch.profiler. Epoch 0 is cold. Prints the card; the median, least and
largest seconds of the unprofiled warm epochs (train steps and validation;
checkpoint writes apart) and their median samples/s; the same for the
profiled epochs (the profiler's own cost is their difference); the device's
busy share of the profiled epochs: device time of the kernels and copies
that start inside an epoch's train-and-validation window over the summed
wall time of those windows (so checkpoint writes between them count in
neither); device time by kernel family, an epoch's mean, with its events
(for masked_mix_slice16, its launches and time per launch); and one JSON
line with the same numbers. A window opens when an epoch's first train step
is called and closes when its second validation split returns, each after a
device synchronize, in wrappers this script puts around the trainer's
methods (the trainer itself is unchanged). Checkpoints go to a scratch
folder in the checkout, removed at the end. Fails without a GPU.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = "pretrain_epoch_window"


def spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "n": len(xs)}


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_pretrain: needs an NVIDIA GPU")
    if args.epochs < 6:
        sys.exit("profile_torch_pretrain: needs 6 epochs or more (a cold one, then warm "
                 "epochs unprofiled and profiled)")
    profiled = args.epochs // 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from profile_torch_eval import bucket

    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.pretrain.trainer import VAL_SPLITS, PassiveTrainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    run_dir = os.path.join(REPO, "_profile_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = get_config(os.path.join(REPO, "configs", "pretrain_passive.yaml"),
                     ["Pretrain.Passive.NUM_EPOCHS", str(args.epochs)], run_dir, "train")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    trainer = PassiveTrainer(cfg, device="cuda")
    steps = trainer._steps_per_epoch
    first = args.epochs - profiled  # the first profiled epoch
    calls = {"train": 0, "val": 0}
    window = []
    train_step, val_losses = trainer.train_step, trainer._val_losses

    def profiled_train_step(*a, **kw):
        if calls["train"] >= first * steps and calls["train"] % steps == 0:
            torch.cuda.synchronize()
            if calls["train"] == first * steps:
                prof.start()
            window.append(torch.profiler.record_function(WINDOW))
            window[-1].__enter__()
        calls["train"] += 1
        return train_step(*a, **kw)

    def profiled_val_losses(*a, **kw):
        out = val_losses(*a, **kw)
        calls["val"] += 1
        if calls["val"] > first * len(VAL_SPLITS) and calls["val"] % len(VAL_SPLITS) == 0:
            torch.cuda.synchronize()
            window[-1].__exit__(None, None, None)
            if calls["val"] == args.epochs * len(VAL_SPLITS):
                prof.stop()
        return out

    trainer.train_step, trainer._val_losses = profiled_train_step, profiled_val_losses
    try:
        trainer.train()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.name == WINDOW
                   and e.device_type == torch.autograd.DeviceType.CPU)
    if len(spans) != profiled:
        sys.exit(f"profile_torch_pretrain: found {len(spans)} epoch windows in the trace, "
                 f"expected {profiled}")
    per_bucket, per_bucket_n, total_us, n_events, outside = {}, {}, 0.0, 0, 0
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.name == WINDOW:
            continue  # (the windows' own device-side annotations too)
        us = evt.time_range.elapsed_us()
        if us <= 0:
            continue
        if not any(a <= evt.time_range.start < b for a, b in spans):
            outside += 1
            continue
        n_events += 1
        total_us += us
        b = bucket(evt.name)
        per_bucket[b] = per_bucket.get(b, 0.0) + us
        per_bucket_n[b] = per_bucket_n.get(b, 0) + 1
    window_s = sum(b - a for a, b in spans) * 1e-6
    busy = total_us * 1e-6 / window_s
    log = trainer.epoch_log
    samples = log[0]["train_samples"]
    warm = spread([e["seconds"] for e in log[1:first]])
    profiled = spread([e["seconds"] for e in log[first:]])
    saves = [e["save_seconds"] for e in log if e["save_seconds"] > 1e-3]
    print(card)
    print(f"pretrain: BATCH_SIZE {trainer._batch_size}, {steps} train steps and "
          f"{len(VAL_SPLITS)} validation batches an epoch; set-up {trainer.setup_s:.3f} s; "
          f"cold epoch {log[0]['seconds']:.4f} s")
    print(f"warm epochs 1-{first - 1} (unprofiled): median {warm['median']:.4f} s "
          f"({samples / warm['median']:.1f} samples/s), least {warm['min']:.4f} s, largest "
          f"{warm['max']:.4f} s; checkpoint writes in {len(saves)} of {len(log)} epochs, "
          f"{min(saves, default=0):.4f}-{max(saves, default=0):.4f} s each, apart")
    print(f"profiled epochs {first}-{args.epochs - 1}: median {profiled['median']:.4f} s "
          f"(least {profiled['min']:.4f}, largest {profiled['max']:.4f}); their windows "
          f"{1e3 * window_s:.2f} ms in all, device time {total_us / 1e3:.2f} ms in {n_events} "
          f"events = busy {100 * busy:.1f}% ({outside} device events outside the windows)")
    for b, us in sorted(per_bucket.items(), key=lambda kv: -kv[1]):
        print(f"  {b:20s} {us / 1e3 / profiled:9.3f} ms an epoch  "
              f"{100 * us / max(total_us, 1e-9):5.1f}%  {per_bucket_n[b]} events, "
              f"{us / per_bucket_n[b]:.3f} us each")
    print(json.dumps({
        "card": card, "setup_s": trainer.setup_s, "epochs": log,
        "warm_unprofiled_s": warm, "profiled_s": profiled, "window_ms": 1e3 * window_s,
        "device_ms": total_us / 1e3, "busy_share": busy, "events_outside": outside,
        "buckets_ms": {b: us / 1e3 for b, us in per_bucket.items()},
        "buckets_events": per_bucket_n,
    }))


if __name__ == "__main__":
    main()

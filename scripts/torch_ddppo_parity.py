#!/usr/bin/env python3
"""Readings of chip_smoke.py phase 8i's ddppo-parity gate alone, on the card.

    python scripts/torch_ddppo_parity.py [K]

Pretrains the passive separators as phase 6 does (3 epochs, full width),
then runs ``chip_smoke.ddppo_parity`` K times (default 6): 2 ranks x 7 envs
against 1 rank x 14 on the one card over gloo, TF32 off, one update and
refit in float32 and in float64 and a whole cycle in float32, each reading
printed as the phase prints it. A reading outside the gate prints its
failure and the next one runs; the exit code counts the failed readings.
"""

import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    import chip_smoke
    from move2hear_tpu_torch.ops import build, kernels

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: the readings need the card")
    card = chip_smoke.card_line()
    print(card, flush=True)
    build.build_all()
    run_dir = os.path.join(REPO, "_smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    failed = 0
    try:
        _, ckpts = chip_smoke.pretrain_phase(torch, kernels, card, os.path.join(run_dir, "pretrain"))
        pre = ["RL.PPO.pretrained_passive_separators_ckpt",
               os.path.join(ckpts, "best_ckpt_nonoverlapping_val.pth")]
        for i in range(k):
            t0 = time.perf_counter()
            try:
                chip_smoke.ddppo_parity(torch, os.path.join(run_dir, f"parity{i}"), pre, "cuda:0",
                                        {"INTERRUPTED_STATE_DIR": os.path.join(run_dir, "states")})
            except SystemExit:
                failed += 1
            print(f"reading {i + 1} of {k}: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    print(f"{k - failed} of {k} readings within the gates", flush=True)
    sys.exit(failed)


if __name__ == "__main__":
    main()

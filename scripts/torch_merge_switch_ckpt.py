#!/usr/bin/env python3
"""Merge a far-target (navigation) checkpoint and a near-target
(quality-improvement) checkpoint of the PyTorch port into one switch-policy
checkpoint for far-target evaluation (``configs/test/farTarget.yaml``).

Usage:
    python scripts/torch_merge_switch_ckpt.py NAV_CKPT QUALIMPROV_CKPT OUT_CKPT
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from move2hear_tpu_torch.eval.switch import merge_switch_policy_checkpoint  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nav_ckpt")
    ap.add_argument("qual_improv_ckpt")
    ap.add_argument("out_ckpt")
    args = ap.parse_args(argv)
    out = merge_switch_policy_checkpoint(args.nav_ckpt, args.qual_improv_ckpt, args.out_ckpt)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Convert a checkpoint of the reference (SAGNIKMJR/move2hear-active-AV-separation,
PyTorch) into the PyTorch port's checkpoint format, so the port evaluates it
or trains from it. The three reference layouts are detected: RL agent
(``ckpt.N.pth``), passive pretrain (``best_ckpt_*.pth``) and switch policy.

Usage:
    python scripts/torch_import_ref_ckpt.py IN.pth OUT.pth

The input is a full pickle: convert only files you trust.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from move2hear_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from move2hear_tpu_torch.utils.torch_import import (  # noqa: E402
    convert_checkpoint,
    detect_layout,
    detect_use_ddppo,
    load_reference_checkpoint,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_ckpt")
    ap.add_argument("out_ckpt")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.ref_ckpt)
    raw = load_reference_checkpoint(src)
    layout = detect_layout(raw)
    save_checkpoint(args.out_ckpt, convert_checkpoint(raw, source=src))
    if layout == "switch":
        agents = {k: raw[k] for k in ("state_dict_nav", "state_dict_qualImprov")}
    else:
        agents = {"state_dict": raw.get("state_dict", raw)} if layout == "agent" else {}
    variant = {k: detect_use_ddppo(sd) for k, sd in agents.items()}
    print(f"imported {layout} checkpoint {src} -> {args.out_ckpt}"
          + (f"; DDPPO acoustic memory {variant} (evaluate with RL.PPO.use_ddppo to match)"
             if variant else ""))


if __name__ == "__main__":
    main()

"""Small host-side utilities (``common/utils.py:53-125``)."""

import glob
import os
from typing import Optional

import numpy as np
import torch

# the `TPU` dtype knobs and the values each takes; SEP_REFIT_DTYPE's ""
# keeps COMPUTE_DTYPE
DTYPE_KNOBS = {
    "COMPUTE_DTYPE": ("float32", "bfloat16"),
    "SEP_SLAB_DTYPE": ("float32", "bfloat16"),
    "SEP_REFIT_DTYPE": ("", "float32", "bfloat16"),
    "SUB_BANK_DTYPE": ("float32", "bfloat16"),
}


def tpu_dtype(tpu, key: str) -> Optional[torch.dtype]:
    """The torch dtype the `TPU` knob `key` names (None for ""). A value
    outside DTYPE_KNOBS[key] raises ValueError: a typo must not run in
    float32 without a word."""
    default = "" if key == "SEP_REFIT_DTYPE" else "float32"
    value = str(tpu.get(key, default))
    if value not in DTYPE_KNOBS[key]:
        raise ValueError(f"TPU.{key}={value!r}: expected one of {DTYPE_KNOBS[key]}")
    return getattr(torch, value) if value else None


def linear_decay(epoch: int, total_num_updates: int) -> float:
    """LR/clip multiplier decaying linearly to 0 (utils.py:53-63)."""
    return 1.0 - (epoch / float(total_num_updates))


def linear_decay_float32(epoch: int, total_num_updates: int) -> float:
    """``linear_decay`` as the JAX package's fused cycle computes it on the
    device, in float32 from the update index
    (``1.0 - idx.astype(float32) / num_updates_total``, with at least one
    update): one float32 ulp from ``float32(linear_decay(...))`` at some
    indices (4, 5, 7, 8, 10 and 11 of 12)."""
    total = np.float32(max(1, int(total_num_updates)))
    return float(np.float32(1.0) - np.float32(epoch) / total)


def poll_checkpoint_folder(
    checkpoint_folder: str, previous_ckpt_ind: int, eval_interval: int = 1
) -> Optional[str]:
    """mtime-ordered discovery of the next unevaluated checkpoint: a path,
    or None when there is none yet."""
    if not os.path.isdir(checkpoint_folder):
        raise NotADirectoryError(checkpoint_folder)
    models_paths = [
        p for p in glob.glob(os.path.join(checkpoint_folder, "*")) if os.path.isfile(p)
    ]
    models_paths.sort(key=os.path.getmtime)
    ind = previous_ckpt_ind + eval_interval
    if ind < len(models_paths):
        return models_paths[ind]
    return None

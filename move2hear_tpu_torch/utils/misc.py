"""Small host-side utilities (``common/utils.py:53-125``)."""

import glob
import os
from typing import Optional


def linear_decay(epoch: int, total_num_updates: int) -> float:
    """LR/clip multiplier decaying linearly to 0 (utils.py:53-63)."""
    return 1.0 - (epoch / float(total_num_updates))


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

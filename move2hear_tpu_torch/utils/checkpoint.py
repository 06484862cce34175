"""The port's checkpoint format: one ``torch.save`` file holding a state
dict and the config dict,

    {"state_dict": {...}, "config": {...}}                      # one policy
    {"state_dict_nav": ..., "state_dict_qualImprov": ...,
     "config_nav": ..., "config_qualImprov": ...}               # switch policy

The switch layout is the reference's own; ``eval/switch.py`` (CLI
``scripts/torch_merge_switch_ckpt.py``) writes it from a far-target and a
near-target checkpoint. A checkpoint converted from the reference
(``utils/torch_import.py``, CLI ``scripts/torch_import_ref_ckpt.py``) has
one of these layouts with ``config`` ``{}`` and adds ``imported_from`` and
``layout``. A state dict is always in the port's names; a reference state
dict (keys ``actor_critic.…``) is refused where it would be loaded.

A training checkpoint adds both optimizer states and the update count,
``{"optimizer_pol": ..., "optimizer_sep": ..., "extra_state":
{"update_count": n}}``; the evaluator reads its ``state_dict`` and
``config`` like any other, and ``RESUME_CKPT`` reads all of it.

written atomically (temp file + rename) so a polling evaluator never reads
a partial file. It does not read the JAX package's flax msgpack checkpoints;
``utils/params.py:from_jax`` converts their parameter trees."""

import os
import tempfile
from typing import Any, Dict

import torch


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Tensors load on the CPU; the caller moves them to its device."""
    return torch.load(path, map_location="cpu", weights_only=True)

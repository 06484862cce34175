"""Reading the reference's PyTorch checkpoints into the port's format (the
JAX package's ``utils/torch_import.py`` and ``scripts/import_torch_ckpt.py``).

The reference (SAGNIKMJR/move2hear-active-AV-separation) saves torch state
dicts in three layouts:

  - RL agent checkpoints ``ckpt.N.pth``: ``{"state_dict":
    agent.state_dict(), "config": ...}``, keys ``actor_critic.<module>...``
    (rl/ppo/ppo_trainer.py:223-238);
  - passive pretrain checkpoints ``best_ckpt_*.pth``: the same over the four
    separator U-Nets, each wrapped in a ``passive_sep_encoder`` /
    ``passive_sep_decoder`` adapter (pretrain/passive/policy.py:7-44);
  - switch-policy checkpoints: ``{"state_dict_nav", "config_nav",
    "state_dict_qualImprov", "config_qualImprov"}``.

The port keeps the reference's module and parameter names, so converting is
key surgery, not the JAX converter's layout transposes: strip
``actor_critic.`` and drop the adapter level of the four U-Nets. BatchNorm's
``num_batches_tracked`` stays a 0-d int64 buffer, as the port's
``models/unet.py:BatchNorm2d`` (an ``nn.BatchNorm2d``) holds it. The
reference's config is a pickled yacs node, not a dict the port can merge:
the converted checkpoint stores ``{}`` in its place, so the evaluator uses
the eval config (``EVAL.USE_CKPT_CONFIG``), and records ``imported_from``.

Nothing converts implicitly: the loaders refuse a state dict in the
reference's layout and name ``IMPORT_SCRIPT``.
"""

import pickle
import types
from typing import Any, Dict

import torch

IMPORT_SCRIPT = "scripts/torch_import_ref_ckpt.py"
AGENT_PREFIX = "actor_critic."
_ADAPTER = {
    "binSep_enc": "passive_sep_encoder.",
    "bin2mono_enc": "passive_sep_encoder.",
    "binSep_dec": "passive_sep_decoder.",
    "bin2mono_dec": "passive_sep_decoder.",
}
PASSIVE_MODULES = tuple(_ADAPTER)
AGENT_MODULES = ("pol_net", "action_dist", "critic", "acoustic_mem") + PASSIVE_MODULES


def refuse_reference_layout(state_dict, what: str) -> None:
    """Raise when `state_dict` is in the reference's layout: the port loads
    only its own, and the import script converts."""
    if any(k.startswith(AGENT_PREFIX) or ".passive_sep_encoder." in k
           or ".passive_sep_decoder." in k for k in state_dict):
        raise ValueError(
            f"{what}: the state dict is in the reference's layout (keys "
            f"'{AGENT_PREFIX}...' or a passive_sep_* level); convert the file first: "
            f"python {IMPORT_SCRIPT} IN.pth OUT.pth"
        )


def _port_key(key: str):
    """(top-level module, port key) of a reference key."""
    if not key.startswith(AGENT_PREFIX):
        raise ValueError(f"{key!r} is not under {AGENT_PREFIX!r}: not a reference state dict")
    key = key[len(AGENT_PREFIX):]
    top, _, rest = key.partition(".")
    adapter = _ADAPTER.get(top)
    if adapter is not None:
        if not rest.startswith(adapter):
            raise ValueError(f"{AGENT_PREFIX}{key!r}: expected the {adapter[:-1]} level")
        key = f"{top}.{rest[len(adapter):]}"
    return top, key


def _convert(state_dict, modules) -> Dict[str, torch.Tensor]:
    out = {}
    for ref_key, value in state_dict.items():
        top, key = _port_key(ref_key)
        if top not in modules:
            raise ValueError(f"{ref_key!r}: the port has no module {top!r} in {modules}")
        t = value.detach().cpu()
        if key.endswith("num_batches_tracked"):
            out[key] = t.to(torch.long).reshape(())
        else:
            out[key] = t.to(torch.float32).contiguous()
    # torch before 0.4.1 wrote no num_batches_tracked; the port's BatchNorm has it
    for key in [k for k in out if k.endswith(".running_mean")]:
        out.setdefault(key[: -len("running_mean")] + "num_batches_tracked",
                       torch.zeros((), dtype=torch.long))
    return out


def detect_use_ddppo(state_dict) -> bool:
    """The DDPPO acoustic-memory variant has no BatchNorm (memory_nets.py:11-24)."""
    return not any(k.endswith("acoustic_mem.cnn.1.running_mean") for k in state_dict)


def convert_agent_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A reference RL ``agent.state_dict()`` -> a ``Move2HearPolicy`` state
    dict (either acoustic-memory variant: see ``detect_use_ddppo``)."""
    return _convert(state_dict, AGENT_MODULES)


def convert_passive_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A reference passive-pretrain state dict -> the four U-Nets under the
    port's names (``Move2HearPassiveWoMemoryPolicy``, or the RL policy's
    passive subtrees)."""
    return _convert(state_dict, PASSIVE_MODULES)


def detect_layout(raw: Dict[str, Any]) -> str:
    """"switch", "agent" or "passive" for a loaded reference checkpoint."""
    if "state_dict_nav" in raw and "state_dict_qualImprov" in raw:
        return "switch"
    sd = raw.get("state_dict", raw)
    if any(k.startswith(AGENT_PREFIX + "pol_net.") for k in sd):
        return "agent"
    if sd and all(k.startswith(AGENT_PREFIX) for k in sd):
        return "passive"
    raise ValueError(
        "not a reference checkpoint: no switch-policy state dicts and no keys under "
        f"{AGENT_PREFIX!r} (is it in the port's format already?)"
    )


def convert_checkpoint(raw: Dict[str, Any], source: str = "") -> Dict[str, Any]:
    """A loaded reference checkpoint of any of the three layouts -> the
    port's checkpoint payload (``utils/checkpoint.py``)."""
    layout = detect_layout(raw)
    if layout == "switch":
        return {
            "state_dict_nav": convert_agent_state_dict(raw["state_dict_nav"]), "config_nav": {},
            "state_dict_qualImprov": convert_agent_state_dict(raw["state_dict_qualImprov"]),
            "config_qualImprov": {}, "imported_from": source,
        }
    sd = raw.get("state_dict", raw)
    convert = convert_agent_state_dict if layout == "agent" else convert_passive_state_dict
    return {"state_dict": convert(sd), "config": {}, "imported_from": source}


class _Unresolved(dict):
    """Stands in for a pickled class this process cannot import (the
    reference's yacs ``CfgNode`` config): keeps its items and attributes."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _Unresolved


_LENIENT_PICKLE = types.SimpleNamespace(
    Unpickler=_Unpickler, load=lambda f, **kw: _Unpickler(f, **kw).load(),
    __name__="lenient_pickle",
)


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Unpickle a reference ``.pth`` on the CPU. It is a full pickle (the
    reference saves its config object), so only load files you trust;
    classes this process cannot import load as plain dicts."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_LENIENT_PICKLE)

"""Switch-policy checkpoints for far-target evaluation (the JAX package's
``eval/evaluator.py:merge_switch_policy_checkpoint``; the reference merges
them in ``scripts/farTarget_eval/copy_individualCkptsNCfgs_switchPolicyEval.ipynb``).

A switch checkpoint holds a navigation policy, which acts before
``RL.PPO.time_thres_for_pol_switch``, and a quality-improvement policy,
which acts after it. The port writes the reference's own layout,

    {"state_dict_nav", "config_nav", "state_dict_qualImprov", "config_qualImprov"},

which its evaluator reads (``eval/device_evaluator.py:setup_device_eval``)."""

from move2hear_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from move2hear_tpu_torch.utils.torch_import import refuse_reference_layout

SWITCH_KEYS = ("state_dict_nav", "state_dict_qualImprov")


def merge_switch_policy_checkpoint(nav_ckpt: str, qual_improv_ckpt: str, out: str) -> str:
    """Bundle a far-target (navigation) checkpoint and a near-target
    (quality-improvement) checkpoint of the port into one switch checkpoint
    at `out`, each with its own config. Returns `out`."""
    parts = {}
    for role, path in (("nav", nav_ckpt), ("qualImprov", qual_improv_ckpt)):
        ckpt = load_checkpoint(path)
        if "state_dict" not in ckpt:
            raise KeyError(f"{path} holds {sorted(ckpt)}, not one policy's 'state_dict'")
        refuse_reference_layout(ckpt["state_dict"], path)
        parts[f"state_dict_{role}"] = ckpt["state_dict"]
        parts[f"config_{role}"] = ckpt.get("config")
    save_checkpoint(out, parts)
    return out

"""Return and advantage computation (``common/rollout_storage.py:159-180``):
GAE(gamma, tau) or plain discounted returns, a reverse loop over the
rollout's time axis, as the JAX package's reverse ``lax.scan``."""

from typing import Optional

import torch


def compute_returns(
    rewards: torch.Tensor,      # (T, N, 1)
    value_preds: torch.Tensor,  # (T+1, N, 1), the bootstrap value in slot T
    masks: torch.Tensor,        # (T+1, N, 1) not-done masks
    gamma: float,
    tau: float,
    use_gae: bool = True,
    t_valid: Optional[int] = None,
) -> torch.Tensor:
    """Returns (T+1, N, 1); slot T holds the bootstrap value, the reference's
    buffer layout.

    `t_valid`: the steps collected when the DDPPO preemptive sync cut the
    rollout (ppo_trainer.py:769-782). The bootstrap value then sits in slot
    `t_valid`, the steps from `t_valid` on are absent, and the valid steps'
    returns equal those of the physically truncated buffer; the slots past
    them hold values that the validity-weighted update ignores."""
    t_steps = rewards.shape[0]
    out = [None] * t_steps
    if use_gae:
        gae = torch.zeros_like(rewards[0])
        for t in reversed(range(t_steps)):
            delta = rewards[t] + gamma * value_preds[t + 1] * masks[t + 1] - value_preds[t]
            gae = delta + gamma * tau * masks[t + 1] * gae
            if t_valid is not None and t >= t_valid:
                # absent steps zero the carry, so the advantage at t_valid is 0
                gae = torch.zeros_like(gae)
            out[t] = gae + value_preds[t]
    else:
        ret = value_preds[-1]
        for t in reversed(range(t_steps)):
            if t_valid is not None and t >= t_valid:
                # absent steps carry V_t, so the last valid step reads the
                # bootstrap value in slot t_valid
                ret = value_preds[t]
            else:
                ret = ret * gamma * masks[t + 1] + rewards[t]
            out[t] = ret
    return torch.cat([torch.stack(out), value_preds[-1:]], dim=0)

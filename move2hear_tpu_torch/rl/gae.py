"""Return and advantage computation (``common/rollout_storage.py:159-180``):
GAE(gamma, tau) or plain discounted returns, a reverse loop over the
rollout's time axis, as the JAX package's reverse ``lax.scan``."""

import torch


def compute_returns(
    rewards: torch.Tensor,      # (T, N, 1)
    value_preds: torch.Tensor,  # (T+1, N, 1), the bootstrap value in slot T
    masks: torch.Tensor,        # (T+1, N, 1) not-done masks
    gamma: float,
    tau: float,
    use_gae: bool = True,
) -> torch.Tensor:
    """Returns (T+1, N, 1); slot T holds the bootstrap value, the reference's
    buffer layout."""
    t_steps = rewards.shape[0]
    out = [None] * t_steps
    if use_gae:
        gae = torch.zeros_like(rewards[0])
        for t in reversed(range(t_steps)):
            delta = rewards[t] + gamma * value_preds[t + 1] * masks[t + 1] - value_preds[t]
            gae = delta + gamma * tau * masks[t + 1] * gae
            out[t] = gae + value_preds[t]
    else:
        ret = value_preds[-1]
        for t in reversed(range(t_steps)):
            ret = ret * gamma * masks[t + 1] + rewards[t]
            out[t] = ret
    return torch.cat([torch.stack(out), value_preds[-1:]], dim=0)

"""Categorical action head and critic head (the reference's
``common/utils.py:16-50`` and ``rl/ppo/policy.py:15-23``). Both heads are
linear layers with orthogonal weights and zero bias: gain 0.01 for the
action logits, so the initial policy is close to uniform, and 1 for the
critic."""

from typing import Optional

import torch
from torch import nn


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits  # (B, A)

    @property
    def log_probs_all(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 1) actions drawn with `generator` (on the logits' device)."""
        return torch.multinomial(self.probs(), 1, generator=generator)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1, keepdim=True)  # (B, 1)

    def log_probs(self, actions: torch.Tensor) -> torch.Tensor:
        """actions (B, 1) int -> (B, 1) log-probabilities."""
        return torch.gather(self.log_probs_all, -1, actions.long())

    def entropy(self) -> torch.Tensor:
        """(B,) entropies, -sum(p * log p)."""
        return -torch.sum(self.probs() * self.log_probs_all, dim=-1)


def _orthogonal_linear(num_inputs: int, num_outputs: int, gain: float, generator=None):
    layer = nn.Linear(num_inputs, num_outputs)
    nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class CategoricalNet(nn.Module):
    def __init__(self, num_inputs: int, num_actions: int, generator=None):
        super().__init__()
        self.linear = _orthogonal_linear(num_inputs, num_actions, 0.01, generator)

    def forward(self, x: torch.Tensor) -> Categorical:
        return Categorical(self.linear(x))


class CriticHead(nn.Module):
    def __init__(self, num_inputs: int, generator=None):
        super().__init__()
        self.fc = _orthogonal_linear(num_inputs, 1, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)

"""Categorical action head and critic head (the reference's
``common/utils.py:16-50`` and ``rl/ppo/policy.py:15-23``). Both heads are
linear layers with orthogonal weights and zero bias: gain 0.01 for the
action logits, so the initial policy is close to uniform, and 1 for the
critic. Under a compute dtype both layers run in it (``models/unet.py``) and
hand the logits and the value back as float32, as the JAX package's."""

from typing import Optional, Tuple

import torch
from torch import nn

from move2hear_tpu_torch.models.unet import Linear


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits  # (B, A)

    @property
    def log_probs_all(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def sample(self, generator: Optional[torch.Generator] = None,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """(B, 1) actions drawn with `generator` (on the logits' device) by
        inverse CDF. `rows` (start, total): this batch is rows [start, start
        + B) of a global batch of `total` rows; the uniforms of all `total`
        rows are drawn and this batch's are taken, so every rank of a world
        (one generator, seeded alike) draws its own rows of the one global
        draw, and 2 ranks x N envs sample what 1 rank x 2N envs samples.
        None is (0, B)."""
        probs = self.probs()
        b = probs.shape[0]
        start, total = (0, b) if rows is None else rows
        u = torch.rand((total, 1), generator=generator, device=probs.device,
                       dtype=probs.dtype)[start: start + b]
        cdf = torch.cumsum(probs, dim=-1)
        # the last bin takes what the rounded cdf leaves below 1
        return torch.searchsorted(cdf, u, right=True).clamp_(max=probs.shape[-1] - 1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1, keepdim=True)  # (B, 1)

    def log_probs(self, actions: torch.Tensor) -> torch.Tensor:
        """actions (B, 1) int -> (B, 1) log-probabilities."""
        return torch.gather(self.log_probs_all, -1, actions.long())

    def entropy(self) -> torch.Tensor:
        """(B,) entropies, -sum(p * log p)."""
        return -torch.sum(self.probs() * self.log_probs_all, dim=-1)


def _orthogonal_linear(num_inputs: int, num_outputs: int, gain: float, generator=None,
                       dtype=torch.float32):
    layer = Linear(num_inputs, num_outputs, compute_dtype=dtype)
    nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class CategoricalNet(nn.Module):
    def __init__(self, num_inputs: int, num_actions: int, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = _orthogonal_linear(num_inputs, num_actions, 0.01, generator, dtype)

    def forward(self, x: torch.Tensor) -> Categorical:
        logits = self.linear(x)
        return Categorical(logits if self.linear.compute_dtype is None else logits.float())


class CriticHead(nn.Module):
    def __init__(self, num_inputs: int, generator=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = _orthogonal_linear(num_inputs, 1, 1.0, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value = self.fc(x)
        return value if self.fc.compute_dtype is None else value.float()

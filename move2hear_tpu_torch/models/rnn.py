"""GRU state encoder with masked reset (the reference's
``rl/models/rnn_state_encoder.py``): the hidden state is multiplied by the
not-done mask before every cell application, so a finished episode starts
from zeros. Cell math is torch.nn.GRU's (gate order r, z, n).

The sequence form (the PPO update's) steps the same ``nn.GRU`` over the
time axis, re-masking the hidden state before each step, as the JAX
package's ``lax.scan`` does.

Weights are orthogonal and biases zero, as the reference's
(rnn_state_encoder.py:36-41). flax's ``(in, 3H)`` kernels are the transpose
of torch's ``(3H, in)``; the transpose of an orthogonal matrix is one too."""

import torch
from torch import nn


class GRUStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512, generator=None):
        super().__init__()
        self.rnn = nn.GRU(input_size, hidden_size)
        for name, p in self.rnn.named_parameters():
            if name.startswith("weight"):
                nn.init.orthogonal_(p, generator=generator)
            else:
                nn.init.zeros_(p)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor):
        """Single step: x (B, D), hidden (B, H), masks (B, 1) -> (output, new
        hidden), both (B, H). Sequence: x (T, B, D), masks (T, B, 1) ->
        (outputs (T, B, H), final hidden (B, H))."""
        if x.ndim == 2:
            out, h = self.rnn(x.unsqueeze(0), (hidden * masks).unsqueeze(0))
            return out[0], h[0]
        h = hidden.unsqueeze(0)
        outs = []
        for t in range(x.shape[0]):
            out, h = self.rnn(x[t : t + 1], h * masks[t].unsqueeze(0))
            outs.append(out[0])
        return torch.stack(outs), h[0]

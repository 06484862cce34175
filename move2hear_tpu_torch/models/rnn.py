"""Single-step GRU state encoder with masked reset (the reference's
``rl/models/rnn_state_encoder.py``): the hidden state is multiplied by the
not-done mask before the cell, so a finished episode starts from zeros.
Cell math is torch.nn.GRU's (gate order r, z, n)."""

import torch
from torch import nn


class GRUStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512):
        super().__init__()
        self.rnn = nn.GRU(input_size, hidden_size)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor):
        """x (B, D), hidden (B, H), masks (B, 1) -> (output, new hidden),
        both (B, H)."""
        out, h = self.rnn(x.unsqueeze(0), (hidden * masks).unsqueeze(0))
        return out[0], h[0]

"""GRU state encoder with masked reset (the reference's
``rl/models/rnn_state_encoder.py``): the hidden state is multiplied by the
not-done mask before every cell application, so a finished episode starts
from zeros. Cell math is torch.nn.GRU's (gate order r, z, n).

The sequence form (the PPO update's) steps the same ``nn.GRU`` over the
time axis, re-masking the hidden state before each step, as the JAX
package's ``lax.scan`` does.

Weights are orthogonal and biases zero, as the reference's
(rnn_state_encoder.py:36-41). flax's ``(in, 3H)`` kernels are the transpose
of torch's ``(3H, in)``; the transpose of an orthogonal matrix is one too.

Under a bfloat16 compute dtype the same parameters run an explicit cell,
the JAX package's (``move2hear_tpu/models/rnn.py``): the input-side GEMM
over the whole sequence at once and the hidden-side GEMM a step, each with
bfloat16 operands and bias added after the product; sigmoid and tanh in
bfloat16, the sigmoid as XLA lowers the JAX package's ``nn.sigmoid``,
``1 / (1 + exp(-x))`` with each operation rounding to bfloat16 (not
torch's one rounding of the exact value); the hidden state stays float32,
so ``(1 - z) * n + z * h``
promotes the new state to float32. cuDNN's bfloat16 GRU keeps other
precisions, so ``nn.GRU`` stays the float32 route only."""

import torch
from torch import nn
from torch.nn import functional as F

from move2hear_tpu_torch.models.unet import compute_dtype_of


class GRUStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype_of(dtype)
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
        if self.compute_dtype is not None:
            return self._cast_forward(x, hidden, masks)
        if x.ndim == 2:
            out, h = self.rnn(x.unsqueeze(0), (hidden * masks).unsqueeze(0))
            return out[0], h[0]
        h = hidden.unsqueeze(0)
        outs = []
        for t in range(x.shape[0]):
            out, h = self.rnn(x[t : t + 1], h * masks[t].unsqueeze(0))
            outs.append(out[0])
        return torch.stack(outs), h[0]

    def _cast_forward(self, x, hidden, masks):
        """The explicit cell in ``compute_dtype`` (module docstring)."""
        dt, r = self.compute_dtype, self.rnn
        w_ih, w_hh = r.weight_ih_l0.to(dt), r.weight_hh_l0.to(dt)
        b_ih, b_hh = r.bias_ih_l0.to(dt), r.bias_hh_l0.to(dt)

        def sigmoid(x):
            return 1.0 / (1.0 + torch.exp(-x))

        def cell(h, gi):
            gh = F.linear(h.to(dt), w_hh) + b_hh
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            rg = sigmoid(i_r + h_r)
            z = sigmoid(i_z + h_z)
            n = torch.tanh(i_n + rg * h_n)
            return (1.0 - z) * n + z * h

        if x.ndim == 2:
            h = cell(hidden * masks, F.linear(x.to(dt), w_ih) + b_ih)
            return h, h
        t, b = x.shape[0], x.shape[1]
        gi_all = (F.linear(x.reshape(t * b, -1).to(dt), w_ih) + b_ih).reshape(t, b, -1)
        h, outs = hidden, []
        for i in range(t):
            h = cell(h * masks[i], gi_all[i])
            outs.append(h)
        return torch.stack(outs), h

"""Acoustic memory refiner (the reference's ``rl/models/memory_nets.py``):
concat(sliced pred_mono, sliced masked previous memory prediction) ->
Conv3x3(32) -> [BatchNorm] -> ReLU -> Conv3x3(16), de-sliced back to
(B, 512, 32, 1). BatchNorm exists iff not ``use_ddppo``; it runs in
float32, the convolutions in the compute dtype `dtype` (``models/unet.py``),
which a call's `dtype` overrides (the separator refit's
``TPU.SEP_REFIT_DTYPE``)."""

from typing import Optional

import torch
from torch import nn

from move2hear_tpu_torch.models.unet import BatchNorm2d, Conv2d, kaiming_relu_
from move2hear_tpu_torch.ops.spec import SLICE_FACTOR, deslice16_nchw, slice16_nchw


class AcousticMem(nn.Module):
    def __init__(self, use_ddppo: bool = False, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        convs = (Conv2d(2 * SLICE_FACTOR, 32, 3, padding=1, bias=False, compute_dtype=dtype),
                 Conv2d(32, SLICE_FACTOR, 3, padding=1, bias=False, compute_dtype=dtype))
        for conv in convs:
            kaiming_relu_(conv.weight, generator)
        layers = [convs[0]]
        if not use_ddppo:
            layers.append(BatchNorm2d(32))
        layers += [nn.ReLU(), convs[1]]
        self.cnn = nn.Sequential(*layers)

    def forward(self, pred_mono: torch.Tensor,
                prev_pred_mono_from_mem_masked: torch.Tensor = None,
                sliced: bool = False, dtype: Optional[torch.dtype] = None):
        """sliced=False: (B, F, T, 1) inputs and output. sliced=True: the
        pre-concatenated sliced input (B, 32, F/16, T) as `pred_mono`, and a
        sliced (B, 16, F/16, T) output; the separator refit hoists the slice
        and the concat out of its loop (slicing is a permutation, so a mean
        over all elements is unchanged). `dtype`, if given, is the
        convolutions' compute dtype for this call."""
        if sliced:
            x = pred_mono
        else:
            x = torch.cat(
                [slice16_nchw(pred_mono), slice16_nchw(prev_pred_mono_from_mem_masked)],
                dim=1,
            )
        if dtype is None:
            x = self.cnn(x)
        else:
            for layer in self.cnn:
                x = layer(x, dtype) if isinstance(layer, Conv2d) else layer(x)
        return x if sliced else deslice16_nchw(x)

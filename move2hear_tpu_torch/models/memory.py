"""Acoustic memory refiner (the reference's ``rl/models/memory_nets.py``):
concat(sliced pred_mono, sliced masked previous memory prediction) ->
Conv3x3(32) -> [BatchNorm] -> ReLU -> Conv3x3(16), de-sliced back to
(B, 512, 32, 1). BatchNorm exists iff not ``use_ddppo``."""

import torch
from torch import nn

from move2hear_tpu_torch.models.unet import BatchNorm2d, kaiming_relu_
from move2hear_tpu_torch.ops.spec import SLICE_FACTOR, deslice16_nchw, slice16_nchw


class AcousticMem(nn.Module):
    def __init__(self, use_ddppo: bool = False, generator=None):
        super().__init__()
        convs = (nn.Conv2d(2 * SLICE_FACTOR, 32, 3, padding=1, bias=False),
                 nn.Conv2d(32, SLICE_FACTOR, 3, padding=1, bias=False))
        for conv in convs:
            kaiming_relu_(conv.weight, generator)
        layers = [convs[0]]
        if not use_ddppo:
            layers.append(BatchNorm2d(32))
        layers += [nn.ReLU(), convs[1]]
        self.cnn = nn.Sequential(*layers)

    def forward(self, pred_mono: torch.Tensor,
                prev_pred_mono_from_mem_masked: torch.Tensor = None,
                sliced: bool = False):
        """sliced=False: (B, F, T, 1) inputs and output. sliced=True: the
        pre-concatenated sliced input (B, 32, F/16, T) as `pred_mono`, and a
        sliced (B, 16, F/16, T) output; the separator refit hoists the slice
        and the concat out of its loop (slicing is a permutation, so a mean
        over all elements is unchanged)."""
        if sliced:
            return self.cnn(pred_mono)
        x = torch.cat(
            [slice16_nchw(pred_mono), slice16_nchw(prev_pred_mono_from_mem_masked)],
            dim=1,
        )
        return deslice16_nchw(self.cnn(x))

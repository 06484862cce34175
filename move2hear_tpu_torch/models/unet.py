"""Passive-separator U-Nets (the reference's ``PassiveSepEncCNN`` /
``PassiveSepDecCNN``, ``audio_separation/rl/models/separator_cnn.py``).

  encoder: 5x [Conv 4x4 stride 2 pad 1 (no bias) -> BatchNorm -> LeakyReLU(0.2)]
           with channels in->64->128->256->512->512 over the 16-way sliced
           512x32 spectrogram (32x32 spatial), +1 target-class plane for the
           binaural-extraction variant.
  decoder: 5x [ConvT 4x4 stride 2 pad 1 (no bias) -> BatchNorm -> ReLU] with
           skip concatenation, then a 1x1 Conv with bias; the output is
           de-sliced back to (B, 512, 32, C).

Module and parameter names follow the reference (``cnn.{i}.{0,1}``), so its
state dicts load with ``load_state_dict``. Layers run NCHW; inputs and
outputs keep the sensor layout (B, F, T, C). BatchNorm runs in eval mode.
"""

from typing import List, Sequence

import torch
from torch import nn

from move2hear_tpu_torch.ops.kernels import masked_mix_slice16
from move2hear_tpu_torch.ops.spec import SLICE_FACTOR, deslice16_nchw, slice16_nchw

ENC_CHANNELS = (64, 128, 256, 512, 512)


class PassiveSepEncoder(nn.Module):
    """U-Net encoder. ``convert_bin2mono=False``: sliced mixture log-mag +
    a (target_class + 1) plane, 33 channels. ``convert_bin2mono=True``: the
    sliced ``log1p(clamp(mask * expm1(mix), 0))``, 32 channels, from the
    ``masked_mix_slice16`` kernel.

    Returns (bottleneck (B, 512), skip features deepest-first, NCHW)."""

    def __init__(self, convert_bin2mono: bool = False):
        super().__init__()
        self.convert_bin2mono = convert_bin2mono
        in_ch = 2 * SLICE_FACTOR + (0 if convert_bin2mono else 1)
        blocks = []
        for out_ch in ENC_CHANNELS:
            blocks.append(nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False),
                nn.BatchNorm2d(out_ch),
                nn.LeakyReLU(0.2),
            ))
            in_ch = out_ch
        self.cnn = nn.ModuleList(blocks)

    def forward(
        self,
        mixed_log_mag: torch.Tensor,
        target_class: torch.Tensor = None,
        pred_bin_sep_masks: torch.Tensor = None,
    ):
        if self.convert_bin2mono:
            x = masked_mix_slice16(
                mixed_log_mag.contiguous(), pred_bin_sep_masks.contiguous()
            )
        else:
            x = slice16_nchw(mixed_log_mag)
            b, _, h, w = x.shape
            tc = target_class.reshape(b, 1, 1, 1).to(x.dtype)
            x = torch.cat([x, (tc + 1.0).expand(b, 1, h, w)], dim=1)
        skips: List[torch.Tensor] = []
        for block in self.cnn:
            x = block(x)
            skips.append(x)
        return x.reshape(x.shape[0], -1), skips[:-1][::-1]


class PassiveSepDecoder(nn.Module):
    """U-Net decoder with skip concat; every block is ConvT->BN->ReLU, then
    a 1x1 conv with bias and no activation. Output (B, 512, 32, C) with
    C = 1 (bin2mono) or 2 (binaural masks)."""

    def __init__(self, convert_bin2mono: bool = False):
        super().__init__()
        n_out = SLICE_FACTOR if convert_bin2mono else 2 * SLICE_FACTOR
        ins = (512, 1024, 512, 256, 128)
        outs = (512, 256, 128, 64, n_out)
        blocks = [
            nn.Sequential(
                nn.ConvTranspose2d(i, o, 4, stride=2, padding=1, bias=False),
                nn.BatchNorm2d(o),
                nn.ReLU(),
            )
            for i, o in zip(ins, outs)
        ]
        blocks.append(nn.Sequential(nn.Conv2d(n_out, n_out, 1)))
        self.cnn = nn.ModuleList(blocks)

    def forward(self, bottleneck: torch.Tensor, skips: Sequence[torch.Tensor]):
        x = bottleneck.reshape(bottleneck.shape[0], -1, 1, 1)
        for idx, block in enumerate(self.cnn[:-1]):
            if idx > 0:
                x = torch.cat([x, skips[idx - 1]], dim=1)
            x = block(x)
        return deslice16_nchw(self.cnn[-1](x))

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
outputs keep the sensor layout (B, F, T, C). BatchNorm follows the module's
mode: batch statistics in training mode (the passive pretrain), running
statistics in eval mode (evaluation and the RL path).

A compute dtype (``TPU.COMPUTE_DTYPE`` bfloat16) is flax's ``dtype=``: each
convolution and dense layer casts its input, weight and bias to it and
adds the bias after the product, rounding twice as flax does; parameters
stay float32. BatchNorm runs in float32 on a float32 copy of its input, as
the JAX package's ``dtype=jnp.float32`` BatchNorm, and hands float32 on.
``None`` (float32) runs each layer as its ``nn`` class does.

The weight initialisers of every port module live here, as the JAX
package's do (``move2hear_tpu/models/unet.py``); the other modules import
them. Each takes an optional ``torch.Generator``.
"""

import math
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from move2hear_tpu_torch.ops.kernels import masked_mix_slice16
from move2hear_tpu_torch.ops.spec import SLICE_FACTOR, deslice16_nchw, slice16_nchw
from move2hear_tpu_torch.parallel.dist import all_reduce_, world_size

ENC_CHANNELS = (64, 128, 256, 512, 512)

# The reference's layer_init (separator_cnn.py:56-68, 139-151) passes
# calculate_gain(...) as the *negative-slope* argument `a` of
# kaiming_normal_, so the effective init std is gain(a)/sqrt(fan) with
# gain(a) = sqrt(2 / (1 + a^2)), NOT the textbook kaiming std. Reproduced
# exactly:
#   encoder convs:  a = calculate_gain("leaky_relu", 0.2) = sqrt(2/1.04)
#                   -> scale = 2 / (1 + 2/1.04)
#   decoder convs:  a = calculate_gain("relu") = sqrt(2) -> scale = 2/3
_ENC_SCALE = 2.0 / (1.0 + 2.0 / 1.04)
_DEC_SCALE = 2.0 / 3.0


def variance_scaling_(weight: torch.Tensor, scale: float,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``variance_scaling(scale, "fan_in", "normal")`` with torch's
    fan-in, ``weight[0].numel()``: in * kh * kw for a Conv2d, in for a
    Linear, and out * kh * kw for a ConvTranspose2d, whose weight is
    (in, out, kh, kw); the last is flax's "fan_out" of its (kh, kw, in, out)
    kernel, which is what the JAX package uses there."""
    std = math.sqrt(scale / weight[0].numel())
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)


def kaiming_leaky_(weight, generator=None):
    return variance_scaling_(weight, _ENC_SCALE, generator)


def kaiming_relu_(weight, generator=None):
    return variance_scaling_(weight, _DEC_SCALE, generator)


def compute_dtype_of(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The layers' compute dtype for a module's `dtype`: None (no cast) for
    float32, so a float32 model runs the ``nn`` layers unchanged, and a
    float64 copy of one (the parity tests') stays float64."""
    return None if dtype in (None, torch.float32) else dtype


class _Cast:
    """flax's ``dtype=`` for a layer with ``weight`` and ``bias``, built with
    ``compute_dtype=``: ``forward(x, dtype=None)`` runs in `dtype`, else in
    the layer's ``compute_dtype``; None or float32 is the ``nn`` class's
    own forward."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype_of(compute_dtype)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = compute_dtype_of(self.compute_dtype if dtype is None else dtype)
        if dt is None:
            return super().forward(x)
        y = self._product(x.to(dt), self.weight.to(dt))
        if self.bias is None:
            return y
        b = self.bias.to(dt)
        return y + (b if y.ndim == 2 else b.reshape(-1, 1, 1))


class Conv2d(_Cast, nn.Conv2d):
    def _product(self, x, w):
        return self._conv_forward(x, w, None)


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    def _product(self, x, w):
        return F.conv_transpose2d(x, w, None, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(_Cast, nn.Linear):
    def _product(self, x, w):
        return F.linear(x, w)


def init_dense_(layer: nn.Module, generator=None) -> None:
    """A Conv2d or Linear of the policy's CNNs: ``kaiming_relu`` weight,
    zero bias (flax's default)."""
    kaiming_relu_(layer.weight, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` under torch's
    names (weight, bias, running_mean, running_var, num_batches_tracked).
    flax's momentum 0.9 is torch's 0.1. In training mode both normalize by
    the biased batch variance, but ``nn.BatchNorm2d`` moves ``running_var``
    towards the unbiased one (n / (n - 1) times larger, 64/63 at the
    bottleneck of a 64-sample batch); flax, and this module, towards the
    biased one. Eval mode is ``nn.BatchNorm2d``'s.

    In training mode in a world of ranks (``parallel/dist.py``) the
    statistics are the global batch's, as XLA computes them over a sharded
    batch: the count, the sum and the sum of squares are summed over the
    world, and their gradients too in the backward."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a bfloat16 input is normalised in the statistics' dtype, float32
        x = x.to(self.running_mean.dtype)
        if not self.training:
            return super().forward(x)
        if world_size() > 1:
            return self._world_forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _world_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        count = torch.full((1,), float(x.numel() // c), dtype=x.dtype, device=x.device)
        sums = _WorldSum.apply(torch.cat([count, x.sum(dim=(0, 2, 3)),
                                          torch.square(x).sum(dim=(0, 2, 3))]))
        mean = sums[1: 1 + c] / sums[0]
        # flax's fast variance, E[x^2] - E[x]^2, as XLA computes it sharded
        var = torch.clamp(sums[1 + c:] / sums[0] - torch.square(mean), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        shape = (1, c, 1, 1)
        return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
                * self.weight.reshape(shape) + self.bias.reshape(shape))


class _WorldSum(torch.autograd.Function):
    """A sum over the world whose backward sums the gradients over it: each
    rank's loss reads the global statistics."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


class PassiveSepEncoder(nn.Module):
    """U-Net encoder. ``convert_bin2mono=False``: sliced mixture log-mag +
    a (target_class + 1) plane, 33 channels. ``convert_bin2mono=True``: the
    sliced ``log1p(clamp(mask * expm1(mix), 0))``, 32 channels, from the
    ``masked_mix_slice16`` kernel.

    Returns (bottleneck (B, 512), skip features deepest-first, NCHW).
    `dtype`: the compute dtype of the convolutions (module docstring)."""

    def __init__(self, convert_bin2mono: bool = False, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convert_bin2mono = convert_bin2mono
        in_ch = 2 * SLICE_FACTOR + (0 if convert_bin2mono else 1)
        blocks = []
        for out_ch in ENC_CHANNELS:
            conv = Conv2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False, compute_dtype=dtype)
            kaiming_leaky_(conv.weight, generator)
            blocks.append(nn.Sequential(conv, BatchNorm2d(out_ch), nn.LeakyReLU(0.2)))
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
    C = 1 (bin2mono) or 2 (binaural masks), in the compute dtype `dtype`."""

    def __init__(self, convert_bin2mono: bool = False, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n_out = SLICE_FACTOR if convert_bin2mono else 2 * SLICE_FACTOR
        ins = (512, 1024, 512, 256, 128)
        outs = (512, 256, 128, 64, n_out)
        blocks = []
        for i, o in zip(ins, outs):
            conv = ConvTranspose2d(i, o, 4, stride=2, padding=1, bias=False, compute_dtype=dtype)
            kaiming_relu_(conv.weight, generator)
            blocks.append(nn.Sequential(conv, BatchNorm2d(o), nn.ReLU()))
        out_conv = Conv2d(n_out, n_out, 1, compute_dtype=dtype)
        init_dense_(out_conv, generator)
        blocks.append(nn.Sequential(out_conv))
        self.cnn = nn.ModuleList(blocks)

    def forward(self, bottleneck: torch.Tensor, skips: Sequence[torch.Tensor]):
        x = bottleneck.reshape(bottleneck.shape[0], -1, 1, 1)
        for idx, block in enumerate(self.cnn[:-1]):
            if idx > 0:
                x = torch.cat([x, skips[idx - 1]], dim=1)
            x = block(x)
        return deslice16_nchw(self.cnn[-1](x))

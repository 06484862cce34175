"""Spectrogram helper ops: 16-way frequency slicing, mask application,
int16 waveform quantization, L2 magnitude normalization, and the STFT's
Hann window.

Public spectrogram tensors keep the reference sensor layout
(..., F=512, T=32, C). The U-Nets and CNNs run NCHW, so the slicing helpers
come in two forms: ``slice16``/``deslice16`` in the sensor layout (for
parity with the JAX package) and ``slice16_nchw``/``deslice16_nchw``, which
go straight between the sensor layout and the (B, C*16, F/16, T) conv
layout. In both, the sliced channel index is c*16 + chunk, and chunk j
covers frequency rows [j*F/16, (j+1)*F/16).
"""

import numpy as np
import torch

SLICE_FACTOR = 16


def hann_window(n_fft: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic ("fftbins") Hann window, as scipy's get_window('hann'):
    computed in float64, then cast to `dtype`."""
    n = np.arange(n_fft)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    return torch.tensor(win, dtype=dtype, device=device)


def slice16(x: torch.Tensor, slice_factor: int = SLICE_FACTOR) -> torch.Tensor:
    """(..., F, T, C) -> (..., F/k, T, C*k) with out-channel = c*k + chunk."""
    *lead, f, t, c = x.shape
    k = slice_factor
    x = x.reshape(*lead, k, f // k, t, c)
    x = torch.movedim(x, -4, -1)  # (..., f', t, c, chunk)
    return x.reshape(*lead, f // k, t, c * k)


def deslice16(x: torch.Tensor, slice_factor: int = SLICE_FACTOR) -> torch.Tensor:
    """Inverse of :func:`slice16`: (..., F/k, T, C*k) -> (..., F, T, C)."""
    *lead, fp, t, ck = x.shape
    k = slice_factor
    x = x.reshape(*lead, fp, t, ck // k, k)
    x = torch.movedim(x, -1, -4)  # (..., chunk, f', t, c)
    return x.reshape(*lead, k * fp, t, ck // k)


def slice16_nchw(x: torch.Tensor, slice_factor: int = SLICE_FACTOR) -> torch.Tensor:
    """(B, F, T, C) -> NCHW (B, C*k, F/k, T), channel = c*k + chunk."""
    b, f, t, c = x.shape
    k = slice_factor
    x = x.permute(0, 3, 1, 2)  # (B, C, F, T)
    return x.reshape(b, c * k, f // k, t)


def deslice16_nchw(x: torch.Tensor, slice_factor: int = SLICE_FACTOR) -> torch.Tensor:
    """Inverse of :func:`slice16_nchw`: (B, C*k, F/k, T) -> (B, F, T, C)."""
    b, ck, fp, t = x.shape
    k = slice_factor
    return x.reshape(b, ck // k, k * fp, t).permute(0, 2, 3, 1)


def masked_mix(mixed_log_mag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``mask * (exp(mix) - 1)``: the masked linear magnitude."""
    return torch.expm1(mixed_log_mag) * mask


def apply_mask_log1p(mixed_log_mag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``log1p(clamp(mask * (exp(mix) - 1), min=0))``: the bin2mono encoder
    and bin AudioCNN input transform."""
    return torch.log1p(torch.clamp(masked_mix(mixed_log_mag, mask), min=0))


def quantize_int16(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, wrap modulo 2**16 like numpy's float->int16 cast,
    and rescale to [-1, 1). A direct ``.to(torch.int16)`` does not promise
    the wrap, so it is spelled out in int32 arithmetic."""
    r = torch.round(x).to(torch.int32)
    wrapped = torch.remainder(r + 32768, 65536) - 32768
    return wrapped.to(torch.float32) * (1.0 / 32768.0)


def l2_norm_scale(mag: torch.Tensor, target_norm: float) -> torch.Tensor:
    """Scale magnitude so the RMS over the last two axes equals
    `target_norm`; identity when the RMS is zero or `target_norm` == 0."""
    if target_norm == 0.0:
        return mag
    rms = torch.sqrt(torch.mean(torch.square(mag), dim=(-2, -1), keepdim=True))
    safe = torch.where(rms > 0.0, rms, torch.ones_like(rms))
    scale = torch.where(rms > 0.0, target_norm / safe, torch.ones_like(rms))
    return mag * scale

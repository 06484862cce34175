"""Batched STFT / ISTFT with librosa semantics: n_fft 1023, hop 512, a
periodic Hann window and reflect-padded centring, giving 512 frequency bins
by 32 frames for one second at 16 kHz.

The forward and inverse real FFTs are ``torch.fft`` (cuFFT on the card).
The ISTFT's windowed overlap-add and envelope normalization go through the
``overlap_add`` kernel (ops/kernels.py).
"""

import functools

import torch
import torch.nn.functional as F

from move2hear_tpu_torch.ops.kernels import overlap_add
from move2hear_tpu_torch.ops.spec import hann_window

N_FFT = 1023
HOP_LENGTH = 512
N_FREQ = N_FFT // 2 + 1  # = 512


@functools.lru_cache(maxsize=8)
def _cached_window(n_fft: int, device: str) -> torch.Tensor:
    return hann_window(n_fft, device=device)


def num_frames(length: int, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH) -> int:
    """Number of STFT frames for a centered STFT of a `length`-sample signal."""
    padded = length + 2 * (n_fft // 2)
    return 1 + (padded - n_fft) // hop_length


def stft(
    x: torch.Tensor,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    center: bool = True,
) -> torch.Tensor:
    """Centered STFT of real signals (..., L) -> complex (..., n_freq,
    n_frames), frequency-major like ``librosa.stft``."""
    x = x.to(torch.float32)
    lead, length = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, 1, length)
    if center:
        pad = n_fft // 2
        x = F.pad(x, (pad, pad), mode="reflect")
    frames = x[:, 0].unfold(-1, n_fft, hop_length)  # (N, n_frames, n_fft)
    frames = frames * _cached_window(n_fft, str(x.device))
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)  # (N, n_frames, n_freq)
    return spec.reshape(*lead, *spec.shape[-2:]).transpose(-1, -2)


def stft_mag_phase(
    x: torch.Tensor,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    center: bool = True,
):
    """Magnitude and phase angle of the centered STFT."""
    spec = stft(x, n_fft=n_fft, hop_length=hop_length, center=center)
    return torch.abs(spec), torch.angle(spec)


def istft(
    spec: torch.Tensor,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    length: int = 16000,
    center: bool = True,
) -> torch.Tensor:
    """Inverse STFT with librosa semantics: complex (..., n_freq, n_frames)
    -> real (..., length)."""
    lead, n_frames = spec.shape[:-2], spec.shape[-1]
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames.reshape(-1, *frames.shape[-2:]).contiguous()
    start = n_fft // 2 if center else 0
    # the overlap-add writes only the kept samples: no trim pass follows
    length = min(length, n_fft + hop_length * (n_frames - 1) - start)
    sig = overlap_add(frames, n_fft=n_fft, hop=hop_length, start=start, length=length)
    return sig.reshape(*lead, length)


def istft_mag_phase(
    mag: torch.Tensor,
    phase: torch.Tensor,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    length: int = 16000,
    center: bool = True,
) -> torch.Tensor:
    """ISTFT of ``mag * exp(1j * phase)`` from real magnitude and phase."""
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return istft(spec, n_fft=n_fft, hop_length=hop_length, length=length,
                 center=center)

"""The batched binaural audio frontend: for every env and every source,

    binaural = fftconvolve(mono_raw, rir, mode='same')        # per ear
    binaural = round->int16->float32 / 32768                  # quantize
    per-source binaural STFT -> (mag, phase)                  # gt bin comps
    mono STFT of mono_raw/32768 -> (mag [L2-renormed], phase) # gt mono comps
    mixture = mean_s(binaural) -> STFT -> log1p(mag), phase   # sensor inputs

with the reference's float16 spectrogram storage casts (``cast_f16``).
Outputs keep the reference sensor layout (B, F, T, C).
"""

from typing import NamedTuple, Optional

import torch

from move2hear_tpu_torch.ops.convolve import fftconvolve_same
from move2hear_tpu_torch.ops.spec import l2_norm_scale, quantize_int16
from move2hear_tpu_torch.ops.stft import HOP_LENGTH, N_FFT, stft


class RenderedAudio(NamedTuple):
    """Per-step audio sensors for B envs, S sources, F=512, T=32:
      mixed_bin_audio_mag:   (B, F, T, 2)  log1p magnitude
      mixed_bin_audio_phase: (B, F, T, 2)
      gt_bin_comps:          (B, F, T, 4*S) per source [mag_l, ph_l, mag_r, ph_r]
      gt_mono_comps:         (B, F, T, 2*S) per source [mag, phase]
    """

    mixed_bin_audio_mag: torch.Tensor
    mixed_bin_audio_phase: torch.Tensor
    gt_bin_comps: torch.Tensor
    gt_mono_comps: torch.Tensor


def _f16(x: torch.Tensor, enabled: bool) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32) if enabled else x


def _bin_and_mix(conv: torch.Tensor, cast_f16: bool, mags_only: bool = False):
    """Per-source binaural spectrograms and the mixture spectrogram from the
    quantized convolved waves conv (B, S, 2, L). The mixture spectrum is the
    mean of the per-source spectra (the STFT is linear). With `mags_only`
    the phase channels are zeros."""
    b, s = conv.shape[0], conv.shape[1]
    bin_spec = stft(conv, n_fft=N_FFT, hop_length=HOP_LENGTH)  # (B,S,2,F,T)
    bin_mag = _f16(torch.abs(bin_spec), cast_f16)
    bin_phase = (
        torch.zeros_like(bin_mag) if mags_only
        else _f16(torch.angle(bin_spec), cast_f16)
    )
    comps = torch.stack(
        [bin_mag[:, :, 0], bin_phase[:, :, 0], bin_mag[:, :, 1], bin_phase[:, :, 1]],
        dim=-1,
    )  # (B, S, F, T, 4)
    f, t = comps.shape[2], comps.shape[3]
    gt_bin_comps = torch.movedim(comps, 1, -2).reshape(b, f, t, 4 * s)

    mix_spec = torch.mean(bin_spec, dim=1)  # (B, 2, F, T)
    mix_mag = _f16(torch.abs(mix_spec), cast_f16)
    mix_phase = (
        torch.zeros_like(mix_mag) if mags_only
        else _f16(torch.angle(mix_spec), cast_f16)
    )
    mixed_bin_audio_mag = torch.log1p(torch.movedim(mix_mag, 1, -1))
    mixed_bin_audio_phase = torch.movedim(mix_phase, 1, -1)
    return mixed_bin_audio_mag, mixed_bin_audio_phase, gt_bin_comps


def _mono_comps(mono_mag, mono_phase, b, s):
    mcomps = torch.stack([mono_mag, mono_phase], dim=-1)  # (B, S, F, T, 2)
    f, t = mcomps.shape[2], mcomps.shape[3]
    return torch.movedim(mcomps, 1, -2).reshape(b, f, t, 2 * s)


def render_binaural_mixture(
    mono_wavs: torch.Tensor,
    rirs: torch.Tensor,
    gt_mono_mag_norm: float = 0.0,
    cast_f16: bool = True,
    mags_only: bool = False,
) -> RenderedAudio:
    """mono_wavs (B, S, L) raw int16-scale waveforms; rirs (B, S, R, 2)
    binaural RIRs (zero RIRs stand for unreadable ones)."""
    mono_wavs = mono_wavs.to(torch.float32)
    rirs = rirs.to(torch.float32)
    b, s, _ = mono_wavs.shape
    conv = fftconvolve_same(mono_wavs[:, :, None, :], torch.movedim(rirs, -1, -2))
    conv = quantize_int16(conv)
    mix_mag, mix_phase, gt_bin_comps = _bin_and_mix(conv, cast_f16, mags_only)

    mono_spec = stft(mono_wavs * (1.0 / 32768.0), n_fft=N_FFT, hop_length=HOP_LENGTH)
    mono_mag = _f16(l2_norm_scale(torch.abs(mono_spec), gt_mono_mag_norm), cast_f16)
    mono_phase = (
        torch.zeros_like(mono_mag) if mags_only
        else _f16(torch.angle(mono_spec), cast_f16)
    )
    return RenderedAudio(mix_mag, mix_phase, gt_bin_comps,
                         _mono_comps(mono_mag, mono_phase, b, s))


def render_binaural_mixture_pre(
    mono_rfft: torch.Tensor,
    rirs: Optional[torch.Tensor],
    gt_mono_raw: torch.Tensor,
    mono_len: int,
    gt_mono_mag_norm: float = 0.0,
    cast_f16: bool = True,
    rir_rfft: Optional[torch.Tensor] = None,
    rir_len: int = 0,
    mags_only: bool = False,
) -> RenderedAudio:
    """render_binaural_mixture from PRECOMPUTED per-sound tensors.

    mono_rfft: (B, S, NF, 2) real/imag of rfft(mono, n=nfft), nfft =
        fast_circular_len(mono_len, R).
    rirs: (B, S, R, 2) binaural RIRs, unused when `rir_rfft` is given.
    gt_mono_raw: (B, S, F, T, 2): raw mono STFT magnitude, f16-cast phase.
    rir_rfft: optional (B, S, NF, 2 ears, 2 re/im) precomputed RIR rffts;
        `rir_len` (the time-domain R) is then required for the "same" slice.
    """
    nfft = 2 * (mono_rfft.shape[-2] - 1)
    if rir_rfft is not None:
        b, s = rir_rfft.shape[0], rir_rfft.shape[1]
        r = rir_len
        h = torch.movedim(torch.complex(rir_rfft[..., 0], rir_rfft[..., 1]), -1, -2)
    else:
        rirs = rirs.to(torch.float32)
        b, s, r = rirs.shape[0], rirs.shape[1], rirs.shape[2]
        h = torch.fft.rfft(torch.movedim(rirs, -1, -2), n=nfft, dim=-1)
    mf = torch.complex(mono_rfft[..., 0], mono_rfft[..., 1])[:, :, None, :]
    full = torch.fft.irfft(mf * h, n=nfft, dim=-1)
    start = (r - 1) // 2
    conv = quantize_int16(full[..., start : start + mono_len])
    mix_mag, mix_phase, gt_bin_comps = _bin_and_mix(conv, cast_f16, mags_only)

    mono_mag = _f16(l2_norm_scale(gt_mono_raw[..., 0], gt_mono_mag_norm), cast_f16)
    mono_phase = torch.zeros_like(mono_mag) if mags_only else gt_mono_raw[..., 1]
    return RenderedAudio(mix_mag, mix_phase, gt_bin_comps,
                         _mono_comps(mono_mag, mono_phase, b, s))

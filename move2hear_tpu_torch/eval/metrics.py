"""Spectrogram-level quality metrics (``common/eval_metrics.py:306-366``).

STFT-L2: mean squared distance between complex spectrograms reconstructed
with the GROUND-TRUTH phase: for predictions only the magnitude is the
model's. Binaural distance is the sum of the left and right mean squared
distances; mono is a single channel.
"""

import torch

from move2hear_tpu_torch.ops.spec import masked_mix


def _real_imag_sqdist(mag_a, phase_a, mag_b, phase_b):
    """Mean over the flattened [real; imag] vector of the squared distance
    between two complex spectra given as (mag, phase)."""
    dr = mag_a * torch.cos(phase_a) - mag_b * torch.cos(phase_b)
    di = mag_a * torch.sin(phase_a) - mag_b * torch.sin(phase_b)
    b = mag_a.shape[0]
    stacked = torch.cat([dr.reshape(b, -1), di.reshape(b, -1)], dim=-1)
    return torch.mean(torch.square(stacked), dim=-1, keepdim=True)  # (B, 1)


def stft_l2_distance(
    mixed_log_mag: torch.Tensor,     # (B, F, T, 2)
    pred_binSepMasks: torch.Tensor,  # (B, F, T, 2)
    gt_bin_comps: torch.Tensor,      # (B, F, T, 4S) [mag_l, ph_l, mag_r, ph_r]*S
    pred_mono: torch.Tensor,         # (B, F, T, 1)
    gt_mono_comps: torch.Tensor,     # (B, F, T, 2S) [mag, ph]*S
):
    """(bin_stft_l2 (B, 1), mono_stft_l2 (B, 1)) for the target source."""
    ph_l, ph_r = gt_bin_comps[..., 1], gt_bin_comps[..., 3]
    pred_bin = masked_mix(mixed_log_mag, pred_binSepMasks)
    bin_l = _real_imag_sqdist(gt_bin_comps[..., 0], ph_l, pred_bin[..., 0], ph_l)
    bin_r = _real_imag_sqdist(gt_bin_comps[..., 2], ph_r, pred_bin[..., 1], ph_r)
    mono_ph = gt_mono_comps[..., 1]
    mono = _real_imag_sqdist(gt_mono_comps[..., 0], mono_ph, pred_mono[..., 0], mono_ph)
    return bin_l + bin_r, mono

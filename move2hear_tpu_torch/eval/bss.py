"""Waveform-level BSS-Eval quality metrics (SI-SDR family) on the host, in
numpy: the JAX package's ``eval/bss.py``, copied so that the port imports
nothing of that package.

The scale-invariant BSS-Eval suite of Le Roux et al. 2019 ("SDR -
half-baked or well done?"), as the reference's nussl-derived
``common/eval_metrics.py:12-303``: SI-SDR / SI-SIR / SI-SAR / SD-SDR / SNR
/ SRR plus improvement-over-mixture variants. Waveforms are reconstructed
by a numpy ISTFT (``np_istft``) with the GT phase for predicted magnitudes,
so the host evaluator launches no ``overlap_add``.
"""

import numpy as np

HOP_LENGTH = 512
N_FFT = 1023
RECONSTRUCTED_SIGNAL_LENGTH = 16000
EPS = 1e-13
NAME_OF_ALL_QUALITY_METRICS = [
    "env", "si_sdr", "si_sir", "si_sar", "sd_sdr", "snr", "srr",
    "si_sdri", "sd_sdri", "snri", "si_siri", "si_sari", "sdr", "sir", "sar",
]


def _np_hann(n):
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def np_istft(mag, phase, length=RECONSTRUCTED_SIGNAL_LENGTH):
    """librosa-semantics ISTFT from (F, T) magnitude + phase."""
    S = mag * np.exp(1j * phase)
    win = _np_hann(N_FFT)
    n_frames = S.shape[1]
    out_len = N_FFT + HOP_LENGTH * (n_frames - 1)
    sig = np.zeros(out_len)
    env = np.zeros(out_len)
    for i in range(n_frames):
        fr = np.fft.irfft(S[:, i], n=N_FFT) * win
        sig[i * HOP_LENGTH : i * HOP_LENGTH + N_FFT] += fr
        env[i * HOP_LENGTH : i * HOP_LENGTH + N_FFT] += win**2
    nz = env > np.finfo(np.float32).tiny
    sig[nz] /= env[nz]
    return sig[N_FFT // 2 :][:length]


def _si_bss_rows(references, estimates, idx, compute_sir_sar=True):
    """Scale-invariant BSS decomposition of several estimates against target
    source `idx`, vectorized over the estimate axis.

    Math per Le Roux et al. 2019 eqs. 5-11 (the same published formulas the
    reference's nussl-derived ``eval_metrics.py:12-57`` implements; epsilon
    regularization placement kept identical for numeric parity).

    references: (n_samples, n_sources); estimates: (m, n_samples).
    Returns an (m, 6) array of rows [si_sdr, si_sir, si_sar, sd_sdr, snr, srr].
    """
    target = references[..., idx]                       # (n,)
    target_energy = target @ target

    alpha = estimates @ target / target_energy          # (m,) optimal scaling
    scaled = alpha[:, None] * target[None, :]           # projection onto target
    residual = estimates - scaled                       # (m, n)

    proj_energy = (scaled**2).sum(axis=1)
    snr = 10 * np.log10(
        target_energy / ((estimates - target[None, :]) ** 2).sum(axis=1)
    )
    si_sdr = 10 * np.log10(proj_energy / (residual**2).sum(axis=1))
    sd_sdr = snr + 10 * np.log10(alpha**2)
    srr = -10 * np.log10((1.0 - 1.0 / alpha) ** 2)

    si_sir = np.full_like(si_sdr, np.nan)
    si_sar = np.full_like(si_sdr, np.nan)
    if compute_sir_sar:
        # interference = least-squares reconstruction of the residual within
        # the span of ALL reference sources; what remains is artifact
        gram = references.T @ references                          # (k, k)
        coeffs = np.linalg.solve(gram, references.T @ residual.T) + EPS
        interference = (references @ coeffs).T                    # (m, n)
        artifact = residual - interference + EPS
        si_sir = 10 * np.log10(proj_energy / (interference**2).sum(axis=1))
        si_sar = 10 * np.log10(proj_energy / (artifact**2).sum(axis=1))

    return np.stack([si_sdr, si_sir, si_sar, sd_sdr, snr, srr], axis=1)


def scale_bss_eval(references, estimate, mixture, idx, compute_sir_sar=True):
    """Full metric tuple including improvement-over-mixture variants
    (eval_metrics.py:60-122). references (n, n_src), estimate (n,),
    mixture (n,). One vectorized decomposition scores the estimate and the
    mixture baseline together."""
    est, mix = _si_bss_rows(
        references, np.stack([estimate, mixture]), idx, compute_sir_sar
    )
    si_sdr, si_sir, si_sar, sd_sdr, snr, srr = est
    return (
        si_sdr, si_sir, si_sar, sd_sdr, snr, srr,
        si_sdr - mix[0], sd_sdr - mix[3], snr - mix[4],
        si_sir - mix[1], si_sar - mix[2],
    )


def evaluate(true_signal, estimated_signal, mixed_signal, compute_sir_sar=True):
    """Mean-centered preprocessing + metric computation
    (eval_metrics.py:172-229). Inputs are lists:
      true_signal / estimated_signal: [np.array (1, n_samples)]
      mixed_signal: [np.array (2, n_samples)] (binaural mixture; averaged to
      mono for the mixture baseline)."""
    references = np.stack(true_signal, axis=-1).transpose(1, 0, 2)
    references = references - references.mean(axis=0)
    estimates = np.stack(estimated_signal, axis=-1).transpose(1, 0, 2)
    estimates = estimates - estimates.mean(axis=0)
    assert len(mixed_signal) == 1
    mixture = mixed_signal[0].T - mixed_signal[0].T.mean(axis=0)
    mixture = np.mean(mixture, axis=1, keepdims=True)

    vals = scale_bss_eval(
        references[..., 0, :], estimates[..., 0, 0], mixture[..., 0], 0,
        compute_sir_sar=compute_sir_sar,
    )
    names = ["si_sdr", "si_sir", "si_sar", "sd_sdr", "snr", "srr",
             "si_sdri", "sd_sdri", "snri", "si_siri", "si_sari"]
    return dict(zip(names, vals))


def compute_waveform_quality(pred_n_gt_spects, eval_metrics_to_compute):
    """Reconstruct mixed / gt-mono / pred-mono / pred-monoFromMem waveforms
    (predictions use GT mono phase) and score both prediction variants
    (eval_metrics.py:256-303).

    pred_n_gt_spects: dict with (1, F, T, C)-shaped numpy arrays:
      mixed_bin_audio_mag (log-less linear mag!), mixed_bin_audio_phase,
      gt_mono_mag, gt_mono_phase, pred_mono, pred_monoFromMem.
    """
    p = pred_n_gt_spects
    mixed = [np.array([
        np_istft(p["mixed_bin_audio_mag"][0, :, :, 0], p["mixed_bin_audio_phase"][0, :, :, 0]),
        np_istft(p["mixed_bin_audio_mag"][0, :, :, 1], p["mixed_bin_audio_phase"][0, :, :, 1]),
    ])]
    gt_mono = [np.array([
        np_istft(p["gt_mono_mag"][0, :, :, 0], p["gt_mono_phase"][0, :, :, 0])
    ])]
    pred_mono = [np.array([
        np_istft(p["pred_mono"][0, :, :, 0], p["gt_mono_phase"][0, :, :, 0])
    ])]
    pred_mem = [np.array([
        np_istft(p["pred_monoFromMem"][0, :, :, 0], p["gt_mono_phase"][0, :, :, 0])
    ])]

    mono_metrics = evaluate(gt_mono, pred_mono, mixed)
    mem_metrics = evaluate(gt_mono, pred_mem, mixed)

    metrics = {"mono": {}, "monoFromMem": {}}
    for metric in eval_metrics_to_compute:
        assert metric in NAME_OF_ALL_QUALITY_METRICS, metric
        metrics["mono"][metric] = mono_metrics[metric]
        metrics["monoFromMem"][metric] = mem_metrics[metric]
    return metrics

"""The port's kernel modules against the JAX package on the CPU: the plain
versions of ``masked_mix_slice16`` and ``overlap_add`` against the Pallas
kernels in interpret mode, and the STFT/ISTFT, convolution, quantization and
frontend ops that surround them. Inputs come from numpy seeds. The CUDA
kernels themselves are held against their plain versions on the card by
tests/test_torch_cuda.py.

Also: the port imports nothing of JAX or the JAX package, and its YAML
reader agrees with ``yaml.safe_load`` on every config of the repo."""

import glob
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.ops.convolve import fast_circular_len as j_fast_len
from move2hear_tpu.ops.convolve import fftconvolve_same as j_fftconv
from move2hear_tpu.ops.frontend import render_binaural_mixture as j_render
from move2hear_tpu.ops.frontend import render_binaural_mixture_pre as j_render_pre
from move2hear_tpu.ops.spec import quantize_int16 as j_quantize
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.ops import stft as t_stft
from move2hear_tpu_torch.ops.convolve import fast_circular_len, fftconvolve_same
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture, render_binaural_mixture_pre
from move2hear_tpu_torch.ops.spec import quantize_int16, slice16, slice16_nchw
from move2hear_tpu_torch.utils.config_tree import load_yaml
from _torch_threads import cap_torch_threads

cap_torch_threads()

# move2hear_tpu.ops re-exports a function named stft over its module
j_stft = importlib.import_module("move2hear_tpu.ops.stft")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # both sides compute in float32; the kernels' math is elementwise


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mix_mask(seed, b=3):
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((b, 512, 32, 2))).astype(np.float32)
    mask = rng.uniform(-0.5, 1.5, (b, 512, 32, 2)).astype(np.float32)
    return mix, mask


def test_masked_mix_slice16_plain_matches_pallas_interpret():
    mix, mask = _mix_mask(0)
    ref = jpk.masked_mix_slice16(jnp.asarray(mix), jnp.asarray(mask),
                                 use_pallas=True, interpret=True)
    out = kernels.masked_mix_slice16(torch.tensor(mix), torch.tensor(mask))
    assert out.shape == (3, 32, 32, 32) and out.is_contiguous()
    # the port returns NCHW (B, 16C, F/16, T); the JAX kernel NHWC
    np.testing.assert_allclose(_np(out.permute(0, 2, 3, 1)), _np(ref), atol=ATOL)


def test_slice16_nchw_is_slice16_in_conv_layout():
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 512, 32, 3)),
                     dtype=torch.float32)
    np.testing.assert_array_equal(
        _np(slice16_nchw(x).permute(0, 2, 3, 1)), _np(slice16(x))
    )


def test_overlap_add_plain_matches_pallas_interpret():
    frames = np.random.default_rng(2).standard_normal((2, 32, 1023)).astype(np.float32)
    ref = jpk.overlap_add(jnp.asarray(frames), use_pallas=True, interpret=True)
    out = kernels.overlap_add(torch.tensor(frames))
    assert out.shape == (2, 1023 + 31 * 512)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)


@pytest.mark.parametrize("b,n_frames,n_fft,hop,start,length", [
    (2, 32, 1023, 512, 511, 16000),  # the eval path's trim
    (2, 1, 1023, 512, 511, 300),     # one frame
    (2, 10, 1023, 200, 100, 1901),   # hop < n_fft/2: up to 6 frames cover a sample
    (2, 5, 1023, 512, 0, 3071),      # odd out_len, the whole signal
    (3, 32, 1023, 512, 511, 16001),  # length not a multiple of 4
    (2, 9, 8, 3, 5, 23),             # hop < 4: a 4-sample run spans several frames
], ids=["path", "one-frame", "hop200", "odd-out-len", "length-16001", "hop3"])
def test_overlap_add_plain_trimmed_equals_slice(b, n_frames, n_fft, hop, start, length):
    frames = torch.tensor(
        np.random.default_rng(n_frames + hop).standard_normal((b, n_frames, n_fft)),
        dtype=torch.float32,
    )
    win, inv_env = kernels.ola_tables(n_fft, hop, n_frames, "cpu")
    full = kernels.overlap_add_plain(frames, win, inv_env, hop)
    assert full.shape == (b, n_fft + hop * (n_frames - 1))
    trimmed = kernels.overlap_add_plain(frames, win, inv_env, hop, start, length)
    assert torch.equal(trimmed, full[:, start : start + length])
    out = kernels.overlap_add(frames, n_fft=n_fft, hop=hop, start=start, length=length)
    assert torch.equal(out, trimmed)


def test_overlap_add_refuses_samples_outside_the_signal():
    frames = torch.zeros((1, 3, 16))
    for start, length in ((-1, 4), (0, 16 + 2 * 4 + 1), (30, 2)):
        with pytest.raises(ValueError):
            kernels.overlap_add(frames, n_fft=16, hop=4, start=start, length=length)


def test_batched_istft_equals_separate_calls():
    """The evaluator's one ISTFT of five stacked signals (gt, mono, mem, mix
    left, mix right) against five separate calls, as the JAX evaluator
    makes them."""
    rng = np.random.default_rng(7)
    mags = np.abs(rng.standard_normal((5, 3, 512, 32))).astype(np.float32)
    phases = rng.uniform(-np.pi, np.pi, (5, 3, 512, 32)).astype(np.float32)
    # In a process that has JAX loaded, the first torch.cos over a large CPU
    # tensor can come back with one intra-op thread's chunk off by up to
    # 1.5e-4; later calls are exact to float32. A first call at this size
    # takes that hit, so the comparison below is of the batching alone.
    t_stft.istft_mag_phase(torch.tensor(mags), torch.tensor(phases))
    batched = t_stft.istft_mag_phase(torch.tensor(mags), torch.tensor(phases))
    assert batched.shape == (5, 3, 16000)
    for i in range(5):
        one = t_stft.istft_mag_phase(torch.tensor(mags[i]), torch.tensor(phases[i]))
        np.testing.assert_allclose(_np(batched[i]), _np(one), atol=1e-6, rtol=0)


def test_istft_matches_jax():
    y = np.random.default_rng(3).standard_normal((2, 16000)).astype(np.float32)
    spec = j_stft.stft(jnp.asarray(y))
    ref = j_stft.istft(spec, length=16000)
    out = t_stft.istft(torch.tensor(np.asarray(spec)), length=16000)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)
    mag, phase = j_stft.stft_mag_phase(jnp.asarray(y))
    ref_mp = j_stft.istft_mag_phase(mag, phase)
    out_mp = t_stft.istft_mag_phase(torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(phase)))
    np.testing.assert_allclose(_np(out_mp), _np(ref_mp), atol=ATOL)


def test_stft_matches_jax():
    y = np.random.default_rng(4).standard_normal((2, 2, 16000)).astype(np.float32)
    ref = np.asarray(j_stft.stft(jnp.asarray(y)))
    out = _np(t_stft.stft(torch.tensor(y)))
    assert out.shape == ref.shape == (2, 2, 512, 32)
    # cuFFT/pocketfft vs the JAX package's DFT matmul: float32 rounding of a
    # 1023-term sum, relative to the spectrum's scale
    np.testing.assert_allclose(out, ref, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("lx,lh", [(16000, 16000), (16000, 400), (1000, 37), (7, 5)])
def test_fftconvolve_same_matches_jax(lx, lh):
    rng = np.random.default_rng(lx + lh)
    x = rng.standard_normal((2, lx)).astype(np.float32)
    h = rng.standard_normal((2, lh)).astype(np.float32)
    assert fast_circular_len(lx, lh) == j_fast_len(lx, lh)
    ref = np.asarray(j_fftconv(jnp.asarray(x), jnp.asarray(h)))
    out = _np(fftconvolve_same(torch.tensor(x), torch.tensor(h)))
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_quantize_int16_wraps_like_numpy():
    x = np.array([0.4, 0.5, 1.5, -2.5, 32767.0, 32768.0, 40000.6, -32769.0,
                  -70000.2, 131071.0], np.float32)
    expected = np.round(x).astype(np.int64).astype(np.int16).astype(np.float32) / 32768
    out = _np(quantize_int16(torch.tensor(x)))
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(out, np.asarray(j_quantize(jnp.asarray(x))))


def _assert_rendered_close(ours, ref):
    """The f16 storage casts turn float32 rounding into occasional one-ulp
    f16 flips (2**-10 relative), and bins where the sources cancel carry
    float32 error relative to the spectrum's peak; and where the float32
    convolutions differ across a rounding boundary of the int16 quantizer,
    each flipped sample moves a frame's bins by up to 2**-15. Hence rtol 2e-3
    plus an atol of 2e-4 (+ 2e-6 of the peak for magnitudes). Phases are compared
    only where the magnitude beside them is above 1e-3 of its peak, since
    the angle of a near-zero bin is arbitrary."""
    for name in ref._fields:
        a, b = _np(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
    np.testing.assert_allclose(_np(ours.mixed_bin_audio_mag),
                               np.asarray(ref.mixed_bin_audio_mag), rtol=2e-3, atol=2e-4)
    for comps, stride in ((ours.gt_bin_comps, ref.gt_bin_comps),
                          (ours.gt_mono_comps, ref.gt_mono_comps)):
        a, b = _np(comps), np.asarray(stride)
        mags = b[..., 0::2]
        np.testing.assert_allclose(a[..., 0::2], mags, rtol=2e-3, atol=2e-4 + 2e-6 * mags.max())
        big = mags > 1e-3 * mags.max()
        d = np.abs(a[..., 1::2] - b[..., 1::2])
        d = np.minimum(d, 2 * np.pi - d)  # +pi and -pi are the same angle
        assert d[big].max() < 1e-2


def test_frontend_matches_jax():
    rng = np.random.default_rng(5)
    mono = (rng.standard_normal((2, 2, 16000)) * 3000).astype(np.float32)
    rirs = (rng.standard_normal((2, 2, 300, 2)) * 0.1).astype(np.float32)
    ref = j_render(jnp.asarray(mono), jnp.asarray(rirs), gt_mono_mag_norm=1.2)
    ours = render_binaural_mixture(torch.tensor(mono), torch.tensor(rirs), gt_mono_mag_norm=1.2)
    _assert_rendered_close(ours, ref)


def test_frontend_pre_with_rir_rfft_matches_jax():
    rng = np.random.default_rng(6)
    b, s, length, r = 2, 2, 16000, 400
    nfft = fast_circular_len(length, r)
    mono = (rng.standard_normal((b, s, length)) * 3000).astype(np.float32)
    rirs = (rng.standard_normal((b, s, r, 2)) * 0.1).astype(np.float32)
    mf = np.fft.rfft(mono, n=nfft, axis=-1)
    hf = np.fft.rfft(rirs, n=nfft, axis=-2)
    mono_rfft = np.stack([mf.real, mf.imag], -1).astype(np.float32)
    rir_rfft = np.stack([hf.real, hf.imag], -1).astype(np.float32)
    gt_raw = np.stack([
        np.abs(rng.standard_normal((b, s, 512, 32))),
        rng.uniform(-np.pi, np.pi, (b, s, 512, 32)),
    ], -1).astype(np.float32)
    args = dict(gt_mono_mag_norm=1.2, rir_len=r)
    ref = j_render_pre(jnp.asarray(mono_rfft), None, jnp.asarray(gt_raw), length,
                       rir_rfft=jnp.asarray(rir_rfft), **args)
    ours = render_binaural_mixture_pre(
        torch.tensor(mono_rfft), None, torch.tensor(gt_raw), length,
        rir_rfft=torch.tensor(rir_rfft), **args,
    )
    _assert_rendered_close(ours, ref)
    # the time-domain RIR path gives the same render
    ours_t = render_binaural_mixture_pre(
        torch.tensor(mono_rfft), torch.tensor(rirs), torch.tensor(gt_raw), length,
        gt_mono_mag_norm=1.2,
    )
    _assert_rendered_close(ours_t, ref)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((1, 512, 32, 2), device="meta")
    with pytest.raises(ValueError):
        kernels.masked_mix_slice16(x, x)
    with pytest.raises(ValueError):
        kernels.overlap_add(torch.zeros((1, 32, 1023), device="meta"))


def test_port_imports_nothing_of_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(jax|flax|optax|move2hear_tpu)(?:\.|\s|$)", re.M
    )
    files = glob.glob(os.path.join(REPO, "move2hear_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "scripts", "profile_torch_eval.py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True)),
    ids=lambda p: os.path.relpath(p, os.path.join(REPO, "configs")),
)
def test_yaml_reader_matches_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert load_yaml(text) == (yaml.safe_load(text) or {})

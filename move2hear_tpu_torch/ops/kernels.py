"""The audio path's kernels: hand-written CUDA on the card, plain PyTorch
on the CPU.

Each public wrapper takes the plain version only for CPU tensors. For CUDA
tensors it checks device, dtype, shape and contiguity, allocates the output,
launches the kernel from ``csrc/`` on PyTorch's current stream and raises if
the launch reports an error; there is no fallback. ``<wrapper>.launches``
counts the kernel launches, so a run can show that it went through them.

1. ``masked_mix_slice16`` (``csrc/masked_mix_slice16.cu``) replaces
   ``move2hear_tpu/ops/pallas_kernels.py:_masked_mix_slice16_kernel``.
   ``log1p(relu(expm1(mix) * mask))`` followed by the 16-way frequency
   slice; on the card the slice permutation is the kernel's store index and
   the result is the NCHW tensor the next Conv2d reads. Bound by bytes. It
   is a ``torch.autograd.Function``: its backward is
   ``masked_mix_slice16_bwd`` (``csrc/masked_mix_slice16_bwd.cu``), which
   replaces the JAX custom VJP ``pallas_kernels.py:_masked_mix_slice16_bwd``
   and reads the cotangent through the inverse slice in its load index.
2. ``overlap_add`` (``csrc/overlap_add.cu``) replaces
   ``move2hear_tpu/ops/pallas_kernels.py:_ola_kernel``: the ISTFT
   overlap-add of Hann-windowed frames times the inverse squared-window
   envelope, optionally only the samples ``[start, start + length)`` that
   the ISTFT keeps. Bound by bytes; each thread gathers 4 consecutive output
   samples from their covering frames in ascending order, no atomics.

The kernels index in 32 bits and put the batch on a grid dimension, so the
wrappers refuse tensors of 2**31 elements or more and batches over 65535.
"""

import functools

import numpy as np
import torch

from move2hear_tpu_torch.ops import build
from move2hear_tpu_torch.ops.spec import (
    SLICE_FACTOR, apply_mask_log1p, deslice16_nchw, hann_window, slice16_nchw,
)


def _require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def _is_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


_MAX_GRID_Y_Z = 65535


def _require_int32_grid(name: str, batch: int, *numels: int) -> None:
    if batch > _MAX_GRID_Y_Z or max(numels) >= 2**31:
        raise ValueError(
            f"{name}: batch {batch} or sizes {numels} exceed the kernel's "
            f"limits ({_MAX_GRID_Y_Z} rows, 32-bit indexing)"
        )


# ---------------------------------------------------------------------------
# 1. fused masked-mix + log1p + slice16
# ---------------------------------------------------------------------------

def masked_mix_slice16_plain(
    mixed_log_mag: torch.Tensor, mask: torch.Tensor, k: int = SLICE_FACTOR
) -> torch.Tensor:
    """The plain version: (B, F, T, C) x (B, F, T, C) -> (B, C*k, F/k, T)."""
    return slice16_nchw(apply_mask_log1p(mixed_log_mag, mask), k).contiguous()


def _check_mm_shapes(name: str, mixed_log_mag: torch.Tensor, mask: torch.Tensor):
    if mixed_log_mag.ndim != 4 or mask.shape != mixed_log_mag.shape:
        raise ValueError(
            f"{name}: shapes {tuple(mixed_log_mag.shape)} and "
            f"{tuple(mask.shape)}; expected two equal (B, F, T, C)"
        )
    b, f, t, c = mixed_log_mag.shape
    if f % SLICE_FACTOR:
        raise ValueError(f"{name}: F={f} is not a multiple of {SLICE_FACTOR}")
    _require_int32_grid(name, b, mixed_log_mag.numel())
    return b, f, t, c


def _masked_mix_slice16_forward(mixed_log_mag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if _is_cpu(mixed_log_mag, mask):
        return masked_mix_slice16_plain(mixed_log_mag, mask)
    _require_cuda_f32("masked_mix_slice16", mixed_log_mag, mask)
    b, f, t, c = _check_mm_shapes("masked_mix_slice16", mixed_log_mag, mask)
    k = SLICE_FACTOR
    out = torch.empty((b, c * k, f // k, t), dtype=torch.float32,
                      device=mixed_log_mag.device)
    lib = build.load("masked_mix_slice16")
    with torch.cuda.device(mixed_log_mag.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.masked_mix_slice16_launch(
            mixed_log_mag.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, f, t, c, k, stream,
        )
    if rc != 0:
        raise RuntimeError(f"masked_mix_slice16: launch failed, CUDA error {rc}")
    masked_mix_slice16.launches += 1
    return out


class _MaskedMixSlice16(torch.autograd.Function):
    """Saves (mix, mask) as the JAX forward does; the backward recomputes
    expm1 and exp from them."""

    @staticmethod
    def forward(ctx, mixed_log_mag, mask):
        ctx.save_for_backward(mixed_log_mag, mask)
        return _masked_mix_slice16_forward(mixed_log_mag, mask)

    @staticmethod
    def backward(ctx, g):
        mixed_log_mag, mask = ctx.saved_tensors
        return masked_mix_slice16_bwd(g.contiguous(), mixed_log_mag, mask)


def masked_mix_slice16(mixed_log_mag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, F, T, C) x (B, F, T, C) -> NCHW (B, 16*C, F/16, T) with channel
    c*16 + chunk: ``slice16(log1p(clamp(expm1(mix) * mask, 0)))``.
    Differentiable in both inputs; a gradient is taken only when an input
    requires one, so inference and the RL path never launch the backward."""
    return _MaskedMixSlice16.apply(mixed_log_mag, mask)


masked_mix_slice16.launches = 0


def masked_mix_slice16_bwd_plain(
    g: torch.Tensor, mixed_log_mag: torch.Tensor, mask: torch.Tensor,
    k: int = SLICE_FACTOR,
) -> tuple:
    """The plain backward, the JAX custom VJP's formula: with
    u = expm1(mix) * mask and du = g / (1 + u) where u > 0 (else 0),
    (dmix, dmask) = (du * exp(mix) * mask, du * expm1(mix)), both
    (B, F, T, C); `g` is the (B, C*k, F/k, T) cotangent of the output."""
    gd = deslice16_nchw(g, k)
    e = torch.expm1(mixed_log_mag)
    u = e * mask
    du = torch.where(u > 0, gd / (1.0 + u), torch.zeros_like(u))
    return du * torch.exp(mixed_log_mag) * mask, du * e


def masked_mix_slice16_bwd(
    g: torch.Tensor, mixed_log_mag: torch.Tensor, mask: torch.Tensor
) -> tuple:
    """(dmix, dmask) of ``masked_mix_slice16`` for the NCHW cotangent `g`
    (B, 16*C, F/16, T); each (B, F, T, C)."""
    if _is_cpu(g, mixed_log_mag, mask):
        return masked_mix_slice16_bwd_plain(g, mixed_log_mag, mask)
    _require_cuda_f32("masked_mix_slice16_bwd", g, mixed_log_mag, mask)
    b, f, t, c = _check_mm_shapes("masked_mix_slice16_bwd", mixed_log_mag, mask)
    k = SLICE_FACTOR
    if g.shape != (b, c * k, f // k, t):
        raise ValueError(
            f"masked_mix_slice16_bwd: cotangent {tuple(g.shape)}; expected "
            f"{(b, c * k, f // k, t)}"
        )
    dmix = torch.empty_like(mixed_log_mag)
    dmask = torch.empty_like(mask)
    lib = build.load("masked_mix_slice16_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.masked_mix_slice16_bwd_launch(
            g.data_ptr(), mixed_log_mag.data_ptr(), mask.data_ptr(),
            dmix.data_ptr(), dmask.data_ptr(), b, f, t, c, k, stream,
        )
    if rc != 0:
        raise RuntimeError(f"masked_mix_slice16_bwd: launch failed, CUDA error {rc}")
    masked_mix_slice16_bwd.launches += 1
    return dmix, dmask


masked_mix_slice16_bwd.launches = 0


# ---------------------------------------------------------------------------
# 2. ISTFT overlap-add
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def ola_tables(n_fft: int, hop: int, n_frames: int, device: str):
    """(periodic Hann window (n_fft,), inverse squared-window envelope
    (out_len,)) as float32 on `device`, built once per shape in float64
    exactly as the JAX package builds them."""
    win = hann_window(n_fft, dtype=torch.float64).numpy()
    out_len = n_fft + hop * (n_frames - 1)
    env = np.zeros(out_len)
    for s in range(n_frames):
        env[s * hop : s * hop + n_fft] += win**2
    tiny = np.finfo(np.float32).tiny
    inv_env = np.where(env > tiny, 1.0 / np.where(env > tiny, env, 1.0), 1.0)
    return (
        torch.tensor(win, dtype=torch.float32, device=device),
        torch.tensor(inv_env, dtype=torch.float32, device=device),
    )


def overlap_add_plain(
    frames: torch.Tensor, win: torch.Tensor, inv_env: torch.Tensor, hop: int,
    start: int = 0, length: int | None = None,
) -> torch.Tensor:
    """The plain version: output samples ``[start, start + length)`` (default
    all), each frame added in ascending order like the kernel."""
    b, n_frames, n_fft = frames.shape
    if length is None:
        length = n_fft + hop * (n_frames - 1) - start
    out = frames.new_zeros((b, length))
    fr = frames * win
    for i in range(n_frames):
        lo, hi = max(i * hop, start), min(i * hop + n_fft, start + length)
        if lo < hi:
            out[:, lo - start : hi - start] += fr[:, i, lo - i * hop : hi - i * hop]
    return out * inv_env[start : start + length]


def overlap_add(
    frames: torch.Tensor, n_fft: int = 1023, hop: int = 512,
    start: int = 0, length: int | None = None,
) -> torch.Tensor:
    """(B, n_frames, n_fft) irfft frames -> (B, length) samples ``[start,
    start + length)`` of the Hann-windowed overlap-add with squared-window
    normalization (the core of librosa.istft). By default the whole
    ``n_fft + hop*(n_frames-1)`` samples, as the TPU kernel computes."""
    if frames.ndim != 3 or frames.shape[-1] != n_fft:
        raise ValueError(
            f"overlap_add: frames {tuple(frames.shape)}; expected (B, n, {n_fft})"
        )
    b, n_frames, _ = frames.shape
    out_len = n_fft + hop * (n_frames - 1)
    if length is None:
        length = out_len - start
    if start < 0 or length < 0 or start + length > out_len:
        raise ValueError(
            f"overlap_add: samples [{start}, {start + length}) outside [0, {out_len})"
        )
    win, inv_env = ola_tables(n_fft, hop, n_frames, str(frames.device))
    if _is_cpu(frames):
        return overlap_add_plain(frames, win, inv_env, hop, start, length)
    _require_cuda_f32("overlap_add", frames)
    _require_int32_grid("overlap_add", b, frames.numel(), b * length)
    out = torch.empty((b, length), dtype=torch.float32, device=frames.device)
    lib = build.load("overlap_add")
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.overlap_add_launch(
            frames.data_ptr(), win.data_ptr(), inv_env.data_ptr(),
            out.data_ptr(), b, n_frames, n_fft, hop, start, length, stream,
        )
    if rc != 0:
        raise RuntimeError(f"overlap_add: launch failed, CUDA error {rc}")
    overlap_add.launches += 1
    return out


overlap_add.launches = 0


KERNEL_WRAPPERS = {
    "masked_mix_slice16": masked_mix_slice16,
    "overlap_add": overlap_add,
    "masked_mix_slice16_bwd": masked_mix_slice16_bwd,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}

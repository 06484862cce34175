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
   Both take a float32 mix with a float32 or a bfloat16 mask (the
   separators' output under ``TPU.COMPUTE_DTYPE`` bfloat16) and write
   float32; the bfloat16-mask variants read the mask as bfloat16 and count
   their launches apart (``masked_mix_slice16_bf16``,
   ``masked_mix_slice16_bwd_bf16``). The mask gradient comes back float32,
   and autograd casts it to the mask's dtype.
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


def _require_cuda(name: str, tensors, pairs=((torch.float32,),)) -> None:
    """`tensors` on one CUDA device, contiguous, with dtypes equal to one of
    the kernel's `pairs` (one dtype a tensor)."""
    dev = tensors[0].device
    got = tuple(t.dtype for t in tensors)
    if got not in pairs:
        raise TypeError(f"{name}: dtypes {got}; the kernel takes {list(pairs)}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
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

# (mix, mask) dtypes the forward kernel takes, and the variant of each
_MM_PAIRS = {(torch.float32, torch.float32): "masked_mix_slice16",
             (torch.float32, torch.bfloat16): "masked_mix_slice16_bf16"}


def masked_mix_slice16_plain(
    mixed_log_mag: torch.Tensor, mask: torch.Tensor, k: int = SLICE_FACTOR
) -> torch.Tensor:
    """The plain version: (B, F, T, C) x (B, F, T, C) -> (B, C*k, F/k, T),
    in the mixture's dtype (a bfloat16 mask is widened to it, exactly)."""
    mask = mask.to(mixed_log_mag.dtype)
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
    _require_cuda("masked_mix_slice16", (mixed_log_mag, mask), tuple(_MM_PAIRS))
    name = _MM_PAIRS[(mixed_log_mag.dtype, mask.dtype)]
    b, f, t, c = _check_mm_shapes(name, mixed_log_mag, mask)
    k = SLICE_FACTOR
    out = torch.empty((b, c * k, f // k, t), dtype=torch.float32,
                      device=mixed_log_mag.device)
    lib = build.load(name)
    with torch.cuda.device(mixed_log_mag.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name + "_launch")(
            mixed_log_mag.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, f, t, c, k, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")
    _ALL_WRAPPERS[name].launches += 1
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
    requires one, so inference and the RL path never launch the backward.
    `mask` is float32 or bfloat16; the output is float32."""
    return _MaskedMixSlice16.apply(mixed_log_mag, mask)


masked_mix_slice16.launches = 0


def masked_mix_slice16_bf16(mixed_log_mag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``masked_mix_slice16`` of a float32 mix and a bfloat16 mask: the
    kernel's bfloat16-mask variant, whose launches this function counts."""
    if mask.dtype != torch.bfloat16:
        raise TypeError(f"masked_mix_slice16_bf16: mask {mask.dtype}, expected bfloat16")
    return masked_mix_slice16(mixed_log_mag, mask)


masked_mix_slice16_bf16.launches = 0


def masked_mix_slice16_bwd_plain(
    g: torch.Tensor, mixed_log_mag: torch.Tensor, mask: torch.Tensor,
    k: int = SLICE_FACTOR,
) -> tuple:
    """The plain backward, the JAX custom VJP's formula: with
    u = expm1(mix) * mask and du = g / (1 + u) where u > 0 (else 0),
    (dmix, dmask) = (du * exp(mix) * mask, du * expm1(mix)), both
    (B, F, T, C) in the mixture's dtype; `g` is the (B, C*k, F/k, T)
    cotangent of the output."""
    mask = mask.to(mixed_log_mag.dtype)
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
    f32 = torch.float32
    _require_cuda("masked_mix_slice16_bwd", (g, mixed_log_mag, mask),
                  tuple((f32,) + pair for pair in _MM_PAIRS))
    name = _MM_PAIRS[(mixed_log_mag.dtype, mask.dtype)].replace(
        "masked_mix_slice16", "masked_mix_slice16_bwd")
    b, f, t, c = _check_mm_shapes(name, mixed_log_mag, mask)
    k = SLICE_FACTOR
    if g.shape != (b, c * k, f // k, t):
        raise ValueError(
            f"masked_mix_slice16_bwd: cotangent {tuple(g.shape)}; expected "
            f"{(b, c * k, f // k, t)}"
        )
    dmix = torch.empty_like(mixed_log_mag)
    dmask = torch.empty_like(mixed_log_mag)  # float32 for either mask
    lib = build.load(name)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name + "_launch")(
            g.data_ptr(), mixed_log_mag.data_ptr(), mask.data_ptr(),
            dmix.data_ptr(), dmask.data_ptr(), b, f, t, c, k, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")
    _ALL_WRAPPERS[name].launches += 1
    return dmix, dmask


masked_mix_slice16_bwd.launches = 0


def masked_mix_slice16_bwd_bf16(
    g: torch.Tensor, mixed_log_mag: torch.Tensor, mask: torch.Tensor
) -> tuple:
    """``masked_mix_slice16_bwd`` with a bfloat16 mask (a float32 dmask):
    the backward's bfloat16-mask variant, whose launches this function
    counts."""
    if mask.dtype != torch.bfloat16:
        raise TypeError(f"masked_mix_slice16_bwd_bf16: mask {mask.dtype}, expected bfloat16")
    return masked_mix_slice16_bwd(g, mixed_log_mag, mask)


masked_mix_slice16_bwd_bf16.launches = 0


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
    _require_cuda("overlap_add", (frames,))
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
# the bfloat16-mask variants, counted apart from the float32 kernels
VARIANT_WRAPPERS = {
    "masked_mix_slice16_bf16": masked_mix_slice16_bf16,
    "masked_mix_slice16_bwd_bf16": masked_mix_slice16_bwd_bf16,
}
_ALL_WRAPPERS = {**KERNEL_WRAPPERS, **VARIANT_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _ALL_WRAPPERS.values():
        fn.launches = 0


def launch_counts(variants: bool = False) -> dict:
    """{kernel: launches} of the three kernels, and with `variants` of the
    bfloat16-mask variants too."""
    wrappers = _ALL_WRAPPERS if variants else KERNEL_WRAPPERS
    return {name: fn.launches for name, fn in wrappers.items()}

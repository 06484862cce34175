"""FFT-based "same"-mode linear convolution for binaural RIR rendering,
matching ``scipy.signal.fftconvolve(x, h, mode="same")``.

Only ``full[start : start + lx]`` of the linear convolution is kept
(``start = (lh - 1) // 2``), so a circular convolution of length NC is exact
on that window as soon as ``NC >= lx + lh - 1 - start``; the length is
rounded up to an even 5-smooth size, which FFT libraries run fast.
"""

import torch


def _next_5_smooth(n: int) -> int:
    """Smallest integer >= n whose prime factors are all in {2, 3, 5}."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            q = -(-n // p35)
            m = p35 << (q - 1).bit_length()
            if m < best:
                best = m
            p35 *= 3
        p5 *= 5
    return best


def fast_circular_len(lx: int, lh: int) -> int:
    """Smallest EVEN 5-smooth FFT length whose circular convolution is
    alias-free on the "same" window. Even, because rfft-bank consumers
    recover it as ``2 * (num_bins - 1)``."""
    n = lx + lh - 1 - (lh - 1) // 2
    return 2 * _next_5_smooth(-(-n // 2))


def fftconvolve_same(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Linear convolution over the last axes (broadcasting leading axes),
    centred "same"-size slice of length ``x.shape[-1]``."""
    x = x.to(torch.float32)
    h = h.to(torch.float32)
    lx, lh = x.shape[-1], h.shape[-1]
    nfft = fast_circular_len(lx, lh)
    start = (lh - 1) // 2
    y = torch.fft.irfft(
        torch.fft.rfft(x, n=nfft, dim=-1) * torch.fft.rfft(h, n=nfft, dim=-1),
        n=nfft, dim=-1,
    )
    return y[..., start : start + lx]

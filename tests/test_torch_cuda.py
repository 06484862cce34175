"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so these tests skip on machines
without a GPU; on the GPU machine run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports no JAX: the GPU machine does not have it."""

import numpy as np
import pytest
import torch

from move2hear_tpu_torch.ops import kernels

ATOL = 1e-5  # float32 elementwise math; the plain versions use the same formulas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_masked_mix_slice16_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    mix = torch.tensor(np.abs(rng.standard_normal((16, 512, 32, 2))), dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.uniform(-0.5, 1.5, (16, 512, 32, 2)), dtype=torch.float32, device=cuda)
    before = kernels.masked_mix_slice16.launches
    out = kernels.masked_mix_slice16(mix, mask)
    torch.cuda.synchronize()
    assert kernels.masked_mix_slice16.launches == before + 1
    assert out.shape == (16, 32, 32, 32)
    torch.testing.assert_close(out, kernels.masked_mix_slice16_plain(mix, mask), atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        kernels.masked_mix_slice16(mix.transpose(1, 2), mask.transpose(1, 2))


@pytest.mark.cuda
def test_overlap_add_kernel_matches_plain(cuda):
    frames = torch.tensor(np.random.default_rng(1).standard_normal((16, 32, 1023)),
                          dtype=torch.float32, device=cuda)
    out = kernels.overlap_add(frames)
    torch.cuda.synchronize()
    win, inv_env = kernels.ola_tables(1023, 512, 32, str(frames.device))
    torch.testing.assert_close(out, kernels.overlap_add_plain(frames, win, inv_env, 512),
                               atol=ATOL, rtol=0)

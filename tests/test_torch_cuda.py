"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so these tests skip on machines
without a GPU; on the GPU machine run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py imports JAX, which the GPU machine
does not have; this file imports none.) The edge shapes are chip_smoke.py's,
so its phase 3 and these tests hold the kernels to the same cases."""

import numpy as np
import pytest
import torch

from chip_smoke import (
    MM_BF16_CASES,
    MM_CASES,
    OLA_CASES,
    mm_bf16_bwd_inputs,
    mm_bf16_inputs,
    mm_bwd_inputs,
    mm_inputs,
    ola_call,
    ola_inputs,
)
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
    # same sums in the same order with non-contracted float ops: bitwise equal
    assert torch.equal(out, kernels.overlap_add_plain(frames, win, inv_env, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(MM_CASES))
def test_masked_mix_slice16_kernel_edge_shapes(cuda, label):
    b, f, t, c, offset = MM_CASES[label]
    mix, mask = mm_inputs(torch, MM_CASES[label])
    assert mix.storage_offset() == offset and mix.is_contiguous()
    out = kernels.masked_mix_slice16(mix, mask)
    torch.cuda.synchronize()
    assert out.shape == (b, 16 * c, f // 16, t)
    torch.testing.assert_close(out, kernels.masked_mix_slice16_plain(mix, mask), atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(OLA_CASES))
def test_overlap_add_kernel_edge_shapes(cuda, label):
    case = OLA_CASES[label]
    (frames,) = ola_inputs(torch, case)
    assert frames.storage_offset() == case[-1] and frames.is_contiguous()
    out = ola_call(kernels, case)(frames)
    torch.cuda.synchronize()
    assert torch.equal(out, ola_call(kernels, case, plain=True)(frames))


@pytest.mark.cuda
def test_wrappers_refuse_grids_over_their_limits(cuda):
    x = torch.zeros((65536, 16, 1, 1), device=cuda)
    with pytest.raises(ValueError):
        kernels.masked_mix_slice16(x, x)
    with pytest.raises(ValueError):
        kernels.overlap_add(torch.zeros((65536, 1, 16), device=cuda), n_fft=16, hop=4)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(MM_CASES))
def test_masked_mix_slice16_bwd_kernel_edge_shapes(cuda, label):
    g, mix, mask = mm_bwd_inputs(torch, MM_CASES[label])
    before = kernels.masked_mix_slice16_bwd.launches
    dmix, dmask = kernels.masked_mix_slice16_bwd(g, mix, mask)
    torch.cuda.synchronize()
    assert kernels.masked_mix_slice16_bwd.launches == before + 1
    pmix, pmask = kernels.masked_mix_slice16_bwd_plain(g, mix, mask)
    torch.testing.assert_close(dmix, pmix, atol=ATOL, rtol=0)
    torch.testing.assert_close(dmask, pmask, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_masked_mix_slice16_function_gradient_matches_plain_autograd(cuda):
    """The autograd.Function's backward (the kernel) against autograd through
    the plain forward, in float32, at the path shape and at C=1."""
    for label in ("path", "C=1"):
        mix, mask = mm_inputs(torch, MM_CASES[label])
        g = torch.randn(kernels.masked_mix_slice16_plain(mix, mask).shape, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
        grads = []
        for fn in (kernels.masked_mix_slice16, kernels.masked_mix_slice16_plain):
            a, b = mix.clone().requires_grad_(True), mask.clone().requires_grad_(True)
            fn(a, b).backward(g)
            grads.append((a.grad, b.grad))
        torch.cuda.synchronize()
        for ours, ref in zip(*grads):
            torch.testing.assert_close(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_masked_mix_slice16_output_carries_a_grad_fn(cuda):
    """The output from inputs that require a gradient is part of the graph
    (the kernel writes through ctypes, so without the autograd.Function the
    gradient would be cut silently), and the backward goes through the
    kernel."""
    mix, mask = mm_inputs(torch, MM_CASES["path"])
    mix.requires_grad_(True)
    out = kernels.masked_mix_slice16(mix, mask)
    assert out.grad_fn is not None
    before = kernels.masked_mix_slice16_bwd.launches
    out.sum().backward()
    torch.cuda.synchronize()
    assert kernels.masked_mix_slice16_bwd.launches == before + 1
    assert mix.grad is not None and torch.isfinite(mix.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(MM_BF16_CASES))
def test_masked_mix_slice16_bf16_mask_kernels_match_plain(cuda, label):
    """The bfloat16-mask variants, forward and backward, at every shape the
    bfloat16 paths launch them at and at the edge shapes: float32 outputs
    (dmask too), each launch counted on its variant."""
    b, f, t, c, offset = MM_BF16_CASES[label]
    mix, mask = mm_bf16_inputs(torch, MM_BF16_CASES[label])
    assert mask.dtype == torch.bfloat16 and mask.storage_offset() == offset
    before = dict(kernels.launch_counts(variants=True))
    out = kernels.masked_mix_slice16(mix, mask)
    g, _, _ = mm_bf16_bwd_inputs(torch, MM_BF16_CASES[label])
    dmix, dmask = kernels.masked_mix_slice16_bwd(g, mix, mask)
    torch.cuda.synchronize()
    after = kernels.launch_counts(variants=True)
    assert {k: after[k] - before[k] for k in after} == {
        "masked_mix_slice16": 0, "overlap_add": 0, "masked_mix_slice16_bwd": 0,
        "masked_mix_slice16_bf16": 1, "masked_mix_slice16_bwd_bf16": 1}
    assert out.dtype == dmix.dtype == dmask.dtype == torch.float32
    assert out.shape == (b, 16 * c, f // 16, t)
    torch.testing.assert_close(out, kernels.masked_mix_slice16_plain(mix, mask), atol=ATOL, rtol=0)
    pmix, pmask = kernels.masked_mix_slice16_bwd_plain(g, mix, mask)
    torch.testing.assert_close(dmix, pmix, atol=ATOL, rtol=0)
    torch.testing.assert_close(dmask, pmask, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_masked_mix_slice16_refuses_other_dtype_pairs(cuda):
    """A float16 mask, or a bfloat16 mixture, raises on the card: only
    (float32, float32) and (float32, bfloat16) have a kernel."""
    mix, mask = mm_bf16_inputs(torch, MM_BF16_CASES["B=1"])
    for pair in ((mix, mask.to(torch.float16)), (mix.to(torch.bfloat16), mask),
                 (mix.double(), mask.double())):
        with pytest.raises(TypeError):
            kernels.masked_mix_slice16(*pair)
    g, _, _ = mm_bf16_bwd_inputs(torch, MM_BF16_CASES["B=1"])
    with pytest.raises(TypeError):
        kernels.masked_mix_slice16_bwd(g, mix, mask.to(torch.float16))


@pytest.mark.cuda
def test_masked_mix_slice16_bf16_mask_gradient_comes_back_bfloat16(cuda):
    """Through autograd the kernel's float32 mask gradient is cast to the
    mask's bfloat16 (the JAX custom VJP hands float32 on; ROADMAP Queue 3)."""
    mix, mask = mm_bf16_inputs(torch, MM_BF16_CASES["collect"])
    a, b = mix.clone().requires_grad_(True), mask.clone().requires_grad_(True)
    out = kernels.masked_mix_slice16(a, b)
    g = torch.randn(out.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    out.backward(g)
    dmix, dmask = kernels.masked_mix_slice16_bwd(g, mix, mask)
    torch.cuda.synchronize()
    assert b.grad.dtype == torch.bfloat16 and torch.equal(b.grad, dmask.to(torch.bfloat16))
    assert torch.equal(a.grad, dmix)


@pytest.mark.cuda
def test_process_vector_env_forks_in_a_process_with_cuda_set_up(cuda):
    """The host env path forks its env workers after the trainer has set
    CUDA up: the workers hold numpy only, step as the in-process envs do,
    and close without touching CUDA."""
    from move2hear_tpu_torch.env.micro_scene import build_micro_scene
    from move2hear_tpu_torch.env.vector_env import ProcessVectorEnv, SyncVectorEnv

    x = torch.ones(1 << 20, device=cuda) * 2  # CUDA set up in this process
    torch.cuda.synchronize()
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400)
    fns = [bundle.make_env_fn(max_episode_steps=3, seed=i) for i in range(3)]
    proc, sync = ProcessVectorEnv(fns), SyncVectorEnv(fns)
    try:
        for a, b in zip(proc.reset(), sync.reset()):
            assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for t in range(7):
            acts = [t % 3, (t + 1) % 3, (t + 2) % 3]
            for p, s in zip(proc.step(acts), sync.step(acts)):
                assert all(np.array_equal(p[0][k], s[0][k]) for k in p[0]) and p[1:] == s[1:]
    finally:
        procs = list(proc._procs)
        proc.close()
    assert all(p.exitcode == 0 for p in procs)
    assert float(x.sum()) == 2 * (1 << 20)  # the parent's CUDA context still works

"""``masked_mix_slice16`` with a float32 mixture and a bfloat16 mask, the
pair the separator chain hands on under ``TPU.COMPUTE_DTYPE`` bfloat16: the
port's plain version (what a CPU tensor takes) against the JAX package's
Pallas kernel in interpret mode and its plain route, and the backward
against the custom VJP. Both JAX routes widen the mask to float32 and write
float32; so does the port. Inputs from a numpy seed. The CUDA variant is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).

Tolerance: rtol 1e-6 of each element, and atol 1e-6 where the interpret
kernel's ``exp(x) - 1`` (Pallas has no expm1) loses the relative precision
of ``expm1`` near x = 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu_torch.ops import kernels
from _torch_threads import cap_torch_threads

cap_torch_threads()

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_pallas_status(monkeypatch):
    # an interpret-mode call records the kernel as available; keep that
    # record out of other tests' default routes
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})


def _inputs(seed, b=3, t=32):
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((b, 512, t, 2))).astype(np.float32)
    mask = rng.uniform(-0.5, 1.5, (b, 512, t, 2)).astype(np.float32)
    mask_b = torch.from_numpy(mask).to(torch.bfloat16)
    return mix, mask_b, jnp.asarray(mask).astype(jnp.bfloat16)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("route", ["interpret", "plain"])
def test_plain_version_matches_the_jax_kernel_for_a_bfloat16_mask(route):
    mix, mask_t, mask_j = _inputs(0)
    ref = jpk.masked_mix_slice16(jnp.asarray(mix), mask_j, use_pallas=route == "interpret",
                                 interpret=route == "interpret")
    assert ref.dtype == jnp.float32
    out = kernels.masked_mix_slice16(torch.from_numpy(mix), mask_t)
    assert out.dtype == torch.float32 and out.shape == (3, 32, 32, 32) and out.is_contiguous()
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # exactly the float32 kernel's function of the widened mask
    assert torch.equal(out, kernels.masked_mix_slice16_plain(torch.from_numpy(mix),
                                                             mask_t.float()))


def test_backward_matches_the_custom_vjp_for_a_bfloat16_mask():
    """(dmix, dmask): the JAX VJP's float32 mask gradient against the port's
    plain backward (float32) and, through autograd, cast to the mask's
    bfloat16."""
    mix, mask_t, mask_j = _inputs(1, b=2)
    g = np.random.default_rng(2).standard_normal((2, 32, 32, 32)).astype(np.float32)  # NHWC

    def f(m, k):
        return jnp.sum(jpk.masked_mix_slice16(m, k, use_pallas=False) * jnp.asarray(g))

    j_dmix, j_dmask = jax.grad(f, argnums=(0, 1))(jnp.asarray(mix), mask_j)
    # JAX hands the VJP's float32 mask gradient on as it is, for a bfloat16
    # mask; torch's autograd casts it to the mask's dtype (ROADMAP Queue 3)
    assert j_dmask.dtype == jnp.float32
    _, vjp = jax.vjp(lambda m, k: jpk.masked_mix_slice16(m, k, use_pallas=False),
                     jnp.asarray(mix), mask_j)
    v_dmix, v_dmask = vjp(jnp.asarray(g))
    g_t = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous()
    dmix, dmask = kernels.masked_mix_slice16_bwd(g_t, torch.from_numpy(mix), mask_t)
    assert dmix.dtype == dmask.dtype == torch.float32
    np.testing.assert_allclose(dmix.numpy(), np.asarray(v_dmix), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dmask.numpy(), np.asarray(v_dmask, np.float32), rtol=RTOL,
                               atol=ATOL)

    mix_t = torch.from_numpy(mix).requires_grad_()
    mask_r = mask_t.clone().requires_grad_()
    (kernels.masked_mix_slice16(mix_t, mask_r) * g_t).sum().backward()
    assert mask_r.grad.dtype == torch.bfloat16 and mix_t.grad.dtype == torch.float32
    np.testing.assert_allclose(mix_t.grad.numpy(), np.asarray(j_dmix), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dmask.numpy(), np.asarray(j_dmask), rtol=RTOL, atol=ATOL)
    # autograd's gradient is the float32 one rounded to bfloat16
    assert torch.equal(mask_r.grad, dmask.to(torch.bfloat16))


def test_the_bfloat16_variants_count_apart_and_launch_only_on_the_card():
    """On CPU tensors both forwards and both backwards take the plain
    version: no count moves. ``launch_counts()`` keeps the three kernels'
    keys; with ``variants`` the two bfloat16-mask variants join them."""
    mix, mask_t, _ = _inputs(3, b=1)
    kernels.reset_launch_counts()
    kernels.masked_mix_slice16_bf16(torch.from_numpy(mix), mask_t)
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.masked_mix_slice16_bf16(torch.from_numpy(mix), mask_t.float())
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    assert kernels.launch_counts(variants=True) == {
        "masked_mix_slice16": 0, "overlap_add": 0, "masked_mix_slice16_bwd": 0,
        "masked_mix_slice16_bf16": 0, "masked_mix_slice16_bwd_bf16": 0}

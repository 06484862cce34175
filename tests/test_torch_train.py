"""The port's training modules against the JAX package's on the CPU: the
masked_mix_slice16 gradient, the separation reward, returns, the sequence
evaluation of actions, one policy update and one separator refit. Inputs
come from numpy seeds at a small size (hidden 64, 2 envs, 3 steps); the
same flax parameters go to both packages (through ``from_jax`` for the
port), and JAX runs with full-precision matmuls. Tolerances: 1e-5 for the
gradient (atol) and the sequence evaluation (rel), 1e-6 for returns, 1e-4
relative for losses and updated parameters (after two Adam steps, so the
optimizer state is compared as well). A parameter is compared relative to
its magnitude plus the learning rate, the size of an Adam step: one that a
step of about lr moved to near zero carries the rounding of that step.

The JAX side of the two updates runs in float64. Adam divides by
sqrt(v) + 1e-5, so a gradient entry near 1e-5 carries its float32 rounding
into the step amplified by lr / 1e-5; JAX's float32 updates on XLA-CPU land
up to 3.6e-4 (refit with BatchNorm) and 1.8e-2 (pose bank, 2 minibatches)
from its own float64 result by that measure, where the port's float32
updates stay within 1e-4 of it. The policy update runs in
test_torch_train_update_pol.py, on this module's helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_rollout, synthetic_sep_slab
from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu.rl.gae import compute_returns as j_compute_returns
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.rl import device_rollout as tdr
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.rl.gae import compute_returns
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, A = 64, 2, 3, 3
N_POSES = 9 * 4  # a 3x3 scene, 4 rotations
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """In a process with JAX loaded, the first call of a torch transcendental
    over a large CPU tensor sometimes returns one intra-op thread's chunk off
    by up to 1.5e-4 relative (ROADMAP, Queue 3); later calls are exact. One
    call of each before the comparisons."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


@pytest.fixture(autouse=True)
def _precise_matmuls_and_plain_route(monkeypatch):
    # a Pallas call in interpret mode records the kernel as available, after
    # which the JAX package's default route would put the Mosaic kernel into
    # a jit on the CPU; each test starts from no record, the CPU route
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    with jax.default_matmul_precision("highest"):
        yield


def _perturbed(tree, rng):
    """Redraw biases and BatchNorm statistics so the weight maps carry
    non-trivial values."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if k in ("mean", "bias"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "var":
            a = (0.5 + rng.uniform(0.0, 1.0, a.shape)).astype(np.float32)
        out[k] = a
    return out


def _weights(use_ddppo=True, seed=0):
    """(JAX policy, flax params, batch stats) with perturbed values."""
    policy = JPolicy(num_actions=A, hidden_size=HID, extra_depth=True, use_ddppo=use_ddppo)
    obs = {
        "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
        "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
        "target_class": jnp.zeros((1, 1), jnp.int32),
    }
    v = jax.jit(policy.init)(jax.random.PRNGKey(seed), obs, jnp.zeros((1, HID)), jnp.ones((1, 1)))
    rng = np.random.default_rng(seed)
    return policy, _perturbed(v["params"], rng), _perturbed(v.get("batch_stats", {}), rng)


def _port_policy(params, stats, use_ddppo=True):
    policy = Move2HearPolicy(A, HID, extra_depth=True, use_ddppo=use_ddppo)
    policy.load_state_dict(from_jax(params, stats))
    return policy.eval()


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _f64(tree):
    """Float arrays of `tree` as float64 JAX arrays (call under
    jax.enable_x64), integer arrays as they are."""
    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f" else a)

    return jax.tree.map(cast, tree)


def _assert_state_close(j_params, stats, policy, prefixes, lr=0.0, rel=REL):
    """The port's parameters under `prefixes` against the JAX tree mapped
    through from_jax: |ours - ref| <= rel * (|ref| + lr)."""
    ref = from_jax(jax.tree.map(np.asarray, j_params), stats)
    ours = policy.state_dict()
    n = 0
    for k, v in ref.items():
        if k.split(".")[0] not in prefixes or not v.is_floating_point():
            continue
        err = (ours[k] - v).abs() / (v.abs() + lr)
        assert float(err.max()) <= rel, (k, float(err.max()))
        n += 1
    assert n > 0


@pytest.mark.parametrize("c", [2, 1])
def test_masked_mix_slice16_gradient_matches_jax_custom_vjp(c):
    rng = np.random.default_rng(c)
    b = 16 if c == 2 else 2
    mix = np.abs(rng.standard_normal((b, 512, 32, c))).astype(np.float32)
    mask = rng.uniform(-0.5, 1.5, (b, 512, 32, c)).astype(np.float32)
    g = rng.standard_normal((b, 32, 32, 16 * c)).astype(np.float32)  # JAX NHWC cotangent
    out, vjp = jax.vjp(
        lambda x, m: jpk.masked_mix_slice16(x, m, use_pallas=True, interpret=True),
        jnp.asarray(mix), jnp.asarray(mask),
    )
    j_dmix, j_dmask = vjp(jnp.asarray(g))
    x, m = torch.tensor(mix, requires_grad=True), torch.tensor(mask, requires_grad=True)
    y = kernels.masked_mix_slice16(x, m)
    assert y.grad_fn is not None
    y.backward(torch.tensor(g).permute(0, 3, 1, 2))  # NHWC -> the port's NCHW
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_dmix), atol=1e-5)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(j_dmask), atol=1e-5)
    # the plain backward is the same function as autograd through the plain forward
    x2, m2 = torch.tensor(mix, requires_grad=True), torch.tensor(mask, requires_grad=True)
    kernels.masked_mix_slice16_plain(x2, m2).backward(torch.tensor(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(m.grad.numpy(), m2.grad.numpy(), atol=1e-5)
    assert kernels.masked_mix_slice16_bwd.launches == 0  # CPU tensors: the plain version


def test_sep_reward_matches_jax_including_the_bonus_step():
    rng = np.random.default_rng(3)
    q_now, q_next = rng.standard_normal((2, 5, 4)).astype(np.float32)
    not_done = (rng.uniform(size=(5, 4)) > 0.3).astype(np.float32)
    at_bonus = rng.uniform(size=(5, 4)) > 0.5
    ref = jdr.sep_reward(q_now, q_next, not_done, at_bonus, 10.0)
    ours = tdr.sep_reward(*map(torch.tensor, (q_now, q_next, not_done, at_bonus)), 10.0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the bonus step doubles extra_mult * q_next and drops the delta
    i = np.argwhere(at_bonus & (not_done > 0))[0]
    assert ours[tuple(i)] == pytest.approx(2 * 10.0 * q_next[tuple(i)], rel=1e-6)


@pytest.mark.parametrize("use_gae", [True, False])
def test_compute_returns_matches_jax(use_gae):
    rng = np.random.default_rng(4)
    rewards = rng.standard_normal((6, 3, 1)).astype(np.float32)
    values = rng.standard_normal((7, 3, 1)).astype(np.float32)
    masks = (rng.uniform(size=(7, 3, 1)) > 0.3).astype(np.float32)
    ref = j_compute_returns(rewards, values, masks, 0.99, 0.95, use_gae)
    ours = compute_returns(*map(torch.tensor, (rewards, values, masks)), 0.99, 0.95, use_gae)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_evaluate_actions_matches_jax_across_an_episode_reset():
    j_policy, params, stats = _weights(seed=1)
    roll = synthetic_rollout(5, T, N, HID, A, frames=True)
    assert roll["masks"][:-1].min() == 0.0  # a mid-sequence reset
    args = (
        {k: v[:-1] for k, v in roll["observations"].items()}, roll["hidden"][0],
        roll["masks"][:-1], roll["actions"], roll["pred_binSepMasks"], roll["pred_mono"],
        roll["prev_pred_monoFromMem"][1:],
    )
    ref = jax.jit(lambda *a: j_policy.apply(
        {"params": params, "batch_stats": stats}, *a, method=JPolicy.evaluate_actions
    ))(*[_j(a) for a in args])
    policy = _port_policy(params, stats)
    with torch.no_grad():
        ours = policy.evaluate_actions(*[_t(a) for a in args])
    for name, o, r in zip(("values", "log_probs", "entropy", "hidden"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("use_ddppo", [True, False])
def test_update_sep_from_slabs_matches_jax(use_ddppo):
    """One cycle's refit (2 updates x 2 epochs) on injected slabs; without
    DDPPO the acoustic memory's BatchNorm runs on its running statistics.
    The JAX reference runs in float64: its float32 refit with BatchNorm on
    XLA-CPU moves the parameters 3.6e-4 (relative to |p| + lr) away from its
    own float64 result, while the port's float32 stays within 3e-6 of it."""
    j_policy, params, stats = _weights(use_ddppo=use_ddppo, seed=3)
    cfg = dict(ppo_epoch=2, num_mini_batch=1)
    slab = synthetic_sep_slab(8, 2 * T, N)
    lr_scales = [1.0, 0.5]

    with jax.enable_x64(True):
        jcfg = jppo.PPOConfig(**cfg)
        j_state = jppo.create_agent_state(jcfg, {"params": _f64(params), "batch_stats": _f64(stats)})
        j_buf = jdr.RolloutSepIdx.create(2 * T, N, 2, slab_dtype=jnp.float64).replace(**_f64(slab))
        update = jdr.make_update_sep_from_slabs(j_policy, jcfg, N, 2)
        j_state, j_losses = jax.jit(update)(j_state, j_buf, jax.random.PRNGKey(0),
                                            jnp.asarray(lr_scales, jnp.float64))
        j_params, j_losses = jax.tree.map(np.asarray, j_state.params), np.asarray(j_losses)

    policy = _port_policy(params, stats, use_ddppo)
    state = tppo.create_agent_state(tppo.PPOConfig(**cfg), policy)
    buf = tdr.RolloutSepIdx.create(2 * T, N, 2)
    for k, v in slab.items():
        getattr(buf, k).copy_(torch.from_numpy(v))
    losses = tdr.make_update_sep_from_slabs(policy, tppo.PPOConfig(**cfg), 2)(
        state, buf, None, lr_scales
    )
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=REL)
    _assert_state_close(j_params, stats, policy, tppo.SEP_TRAIN_KEYS,
                        lr=tppo.PPOConfig().lr_sep)
    # the other groups and every BatchNorm statistic did not move
    _assert_state_close(params, stats, policy, tppo.PASSIVE_KEYS + tppo.POL_KEYS, lr=1.0, rel=0.0)
    ref = from_jax(params, stats)
    for k, v in policy.state_dict().items():
        if "running_" in k:
            assert torch.equal(v, ref[k]), k

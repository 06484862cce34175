"""The validity-masked returns and policy update of DDPPO's preemptive
rollout sync against the JAX package's on the CPU: ``compute_returns``
with ``t_valid`` and ``make_update_pol(with_validity=True)`` (hidden 64, 2
envs, 4 steps of which 2 collected). The JAX update runs in float64
(Adam's eps conditioning, ``tests/test_torch_train.py``), the port's in
float32, within that file's tolerances; the masked update is also held to
the port's plain update on the physically truncated rollout. The refits'
row weights are in ``tests/test_torch_ddppo_refit.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_rollout
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu.rl.gae import compute_returns as j_compute_returns
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.rl.gae import compute_returns
from test_torch_train import _assert_state_close, _f64, _port_policy, _t, _weights
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, A = 64, 2, 4, 3
T_VALID = 2
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """The first call of a torch transcendental over a large CPU tensor in a
    process with JAX loaded can be off by 1.5e-4 (ROADMAP Queue 3): one
    call of each first."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.tanh, torch.sigmoid, torch.sqrt):
        fn(x)


@pytest.fixture(autouse=True)
def _precise_matmuls_and_plain_route(monkeypatch):
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("use_gae", [True, False])
def test_compute_returns_with_t_valid_matches_jax_and_truncation(use_gae):
    rng = np.random.default_rng(0)
    t, n = 8, 3
    rewards = rng.standard_normal((t, n, 1)).astype(np.float32)
    values = rng.standard_normal((t + 1, n, 1)).astype(np.float32)
    masks = rng.integers(0, 2, (t + 1, n, 1)).astype(np.float32)
    values[5] = rng.standard_normal((n, 1))  # the bootstrap of a cut at 5
    ref = np.asarray(j_compute_returns(jnp.asarray(rewards), jnp.asarray(values),
                                       jnp.asarray(masks), 0.99, 0.95, use_gae,
                                       t_valid=jnp.int32(5)))
    ours = compute_returns(*map(torch.from_numpy, (rewards, values, masks)), 0.99, 0.95,
                           use_gae, t_valid=5).numpy()
    np.testing.assert_allclose(ours[:5], ref[:5], rtol=1e-6, atol=1e-6)
    trunc = compute_returns(*map(torch.from_numpy, (rewards[:5], values[:6], masks[:6])),
                            0.99, 0.95, use_gae).numpy()
    np.testing.assert_allclose(ours[:5], trunc[:5], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("num_mini_batch", [1, 2])
def test_masked_update_pol_matches_float64_jax(num_mini_batch, monkeypatch):
    """One update of 2 epochs with the steps from T_VALID on masked; with
    2 minibatches the port takes JAX's env permutations."""
    j_policy, params, stats = _weights(seed=2)
    cfg = dict(ppo_epoch=2, num_mini_batch=num_mini_batch, lr_pol=1e-3)
    roll = synthetic_rollout(6, T, N, HID, A, frames=True)
    with jax.enable_x64(True):
        jcfg = jppo.PPOConfig(**cfg)
        j_state = jppo.create_agent_state(jcfg, {"params": _f64(params), "batch_stats": _f64(stats)})
        update = jppo.make_update_pol(j_policy, jcfg, N, with_validity=True)
        key = jax.random.PRNGKey(0)
        j_state, j_losses = jax.jit(update)(j_state, _f64(roll), key, 0.75, 0.5,
                                            jnp.int32(T_VALID))
        j_params, j_losses = jax.tree.map(np.asarray, j_state.params), np.asarray(j_losses)
        perms = torch.tensor(np.asarray(jppo._epoch_perms(key, 2, N, num_mini_batch)))
    monkeypatch.setattr(tppo, "_epoch_perms", lambda *a, **k: perms)

    runs = []
    for masked in (True, False):
        policy = _port_policy(params, stats)
        state = tppo.create_agent_state(tppo.PPOConfig(**cfg), policy)
        rollouts = _t(roll)
        if not masked:  # the physically truncated rollout, its bootstrap in slot T_VALID
            rollouts = {k: ({s: o[: T_VALID + 1] for s, o in v.items()} if k == "observations"
                            else v[: T_VALID + (k in ("hidden", "value_preds", "returns",
                                                      "masks", "prev_pred_monoFromMem"))])
                        for k, v in rollouts.items()}
        update = tppo.make_update_pol(policy, tppo.PPOConfig(**cfg), N, with_validity=masked)
        losses = update(state, rollouts, None, 0.75, 0.5, t_valid=T_VALID if masked else None)
        runs.append((losses, policy))
    np.testing.assert_allclose(runs[0][0].numpy(), j_losses, rtol=REL)
    _assert_state_close(j_params, stats, runs[0][1], tppo.POL_KEYS, lr=cfg["lr_pol"])
    # the masked update is the plain one on the truncated rollout
    np.testing.assert_allclose(runs[0][0].numpy(), runs[1][0].numpy(), rtol=REL)
    trunc = runs[1][1].state_dict()
    for k, v in runs[0][1].state_dict().items():
        if v.is_floating_point():
            torch.testing.assert_close(v, trunc[k], rtol=REL, atol=REL * cfg["lr_pol"])

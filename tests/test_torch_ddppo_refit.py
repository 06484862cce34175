"""The row-weighted separator refits of DDPPO's preemptive rollout sync
against the JAX package's on the CPU: the device path's cached refit
(``make_update_sep_from_slabs(with_validity=True)``, hidden 64, 2 envs, 8
rows of which 4 filled; JAX in float64, the port in float32, within
``tests/test_torch_train.py``'s tolerances, and equal to the plain refit on
the filled rows) and the host path's rendering refit (``make_update_sep``
with row weights, both packages in float64 on JAX's render, within
``tests/test_torch_host_refit.py``'s tolerances; in
test_torch_ddppo_host_refit.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_sep_slab
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.rl import device_rollout as tdr
from move2hear_tpu_torch.rl import ppo as tppo
from test_torch_train import _assert_state_close, _f64, _port_policy, _weights
from _torch_threads import cap_torch_threads

cap_torch_threads()

N, T, T_VALID = 2, 4, 2
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


def test_weighted_slab_refit_matches_float64_jax():
    """The device path's cached refit (2 updates x 2 epochs) on a buffer
    whose last rows the preemptive sync left stale."""
    j_policy, params, stats = _weights(seed=3)
    cfg = dict(ppo_epoch=2, num_mini_batch=1)
    rows, fill = 2 * T, 2 * T_VALID
    slab = synthetic_sep_slab(8, rows, N)
    lr_scales = [1.0, 0.5]
    with jax.enable_x64(True):
        jcfg = jppo.PPOConfig(**cfg)
        j_state = jppo.create_agent_state(jcfg, {"params": _f64(params), "batch_stats": _f64(stats)})
        j_buf = jdr.RolloutSepIdx.create(rows, N, 2, slab_dtype=jnp.float64).replace(**_f64(slab))
        update = jdr.make_update_sep_from_slabs(j_policy, jcfg, N, 2, with_validity=True)
        row_w = (jnp.arange(rows) < fill).astype(jnp.float64)
        j_state, j_losses = jax.jit(update)(j_state, j_buf, jax.random.PRNGKey(0),
                                            jnp.asarray(lr_scales, jnp.float64), row_w)
        j_params, j_losses = jax.tree.map(np.asarray, j_state.params), np.asarray(j_losses)

    runs = []
    for masked in (True, False):
        policy = _port_policy(params, stats)
        state = tppo.create_agent_state(tppo.PPOConfig(**cfg), policy)
        buf = tdr.RolloutSepIdx.create(rows if masked else fill, N, 2)
        for k, v in slab.items():
            getattr(buf, k).copy_(torch.from_numpy(v if masked else v[:fill]))
        update = tdr.make_update_sep_from_slabs(policy, tppo.PPOConfig(**cfg), 2,
                                                with_validity=masked)
        runs.append((update(state, buf, None, lr_scales, fill=fill if masked else None), policy))
    np.testing.assert_allclose(runs[0][0].numpy(), j_losses, rtol=REL)
    _assert_state_close(j_params, stats, runs[0][1], tppo.SEP_TRAIN_KEYS,
                        lr=tppo.PPOConfig().lr_sep)
    np.testing.assert_allclose(runs[0][0].numpy(), runs[1][0].numpy(), rtol=1e-5)

"""One policy update of the port against the JAX package's on the CPU (2
epochs, the frames or the pose bank, 1 or 2 minibatches), the JAX side in
float64, at tests/test_torch_train.py's size and tolerances (1e-4 relative
for losses and updated parameters; split from it)."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_rollout
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.rl import ppo as tppo
from test_torch_train import (
    A,
    HID,
    N,
    N_POSES,
    REL,
    T,
    _assert_state_close,
    _f64,
    _port_policy,
    _precise_matmuls_and_plain_route,
    _t,
    _warm_torch_cpu_math,
    _weights,
)
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("pose_bank,num_mini_batch", [(False, 1), (True, 1), (True, 2)])
def test_update_pol_matches_jax(pose_bank, num_mini_batch, monkeypatch):
    """One update of 2 epochs (two Adam steps a minibatch) on an injected
    rollout. With 2 minibatches the port takes JAX's env permutations (the
    two packages' generators differ)."""
    j_policy, params, stats = _weights(seed=2)
    cfg = dict(ppo_epoch=2, num_mini_batch=num_mini_batch, lr_pol=1e-3)
    roll = synthetic_rollout(6, T, N, HID, A, n_poses=N_POSES if pose_bank else None,
                             frames=not pose_bank)
    rng = np.random.default_rng(7)
    banks = {"rgb": rng.integers(0, 256, (1, 9, 4, 128, 128, 3)).astype(np.uint8),
             "depth": rng.uniform(0, 1, (1, 9, 4, 128, 128, 1)).astype(np.float32)}

    with jax.enable_x64(True):
        jcfg = jppo.PPOConfig(**cfg)
        j_state = jppo.create_agent_state(jcfg, {"params": _f64(params), "batch_stats": _f64(stats)})
        update = jppo.make_update_pol(j_policy, jcfg, N, pose_bank=pose_bank)
        key = jax.random.PRNGKey(0)
        j_state, j_losses = jax.jit(update)(
            j_state, _f64(roll), key, 0.75, 0.5, banks=_f64(banks) if pose_bank else None,
        )
        j_params, j_losses = jax.tree.map(np.asarray, j_state.params), np.asarray(j_losses)
        perms = torch.tensor(np.asarray(jppo._epoch_perms(key, 2, N, num_mini_batch)))
    monkeypatch.setattr(tppo, "_epoch_perms", lambda *a, **k: perms)

    policy = _port_policy(params, stats)
    state = tppo.create_agent_state(tppo.PPOConfig(**cfg), policy)
    losses = tppo.make_update_pol(policy, tppo.PPOConfig(**cfg), N, pose_bank=pose_bank)(
        state, _t(roll), None, 0.75, 0.5, banks=_t(banks) if pose_bank else None,
    )
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=REL)
    _assert_state_close(j_params, stats, policy, tppo.POL_KEYS, lr=cfg["lr_pol"])
    # the frozen groups did not move
    _assert_state_close(params, stats, policy, tppo.PASSIVE_KEYS + tppo.SEP_TRAIN_KEYS,
                        lr=1.0, rel=0.0)

"""The port's TPU.PAIRWISE_FUSION training against the JAX package's
pairwise programs (``move2hear_tpu/rl/device_rollout.py:
make_collect_and_update``, then the cached refit) on the CPU, in float64 on
both sides, as tests/test_torch_fusion_fused.py holds TPU.FUSED_CYCLE: the
port's float64 trainer records its collects, and the JAX side replays them
through one collect-and-update program a rollout, the host's decay rounded
to float32 as its trainer passes it, each rollout's slab written into a
float64 refit buffer (the float64 port's SEP_SLAB_DTYPE), then its refit.
Tolerance as there."""

import jax
import jax.numpy as jnp
import numpy as np

from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu.utils.misc import linear_decay
from test_torch_fusion_fused import (
    CYCLE, N, T, _f64, assert_matches, carry0, jax_weights, port_float64_run, replaying_collect,
)
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_pairwise_fusion_matches_the_jax_pairwise_programs(tmp_path, monkeypatch):
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    j_policy, params, stats = jax_weights(seed=1)
    trainer, collects = port_float64_run(tmp_path, "PAIRWISE_FUSION", params, stats)
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        jcfg = jppo.PPOConfig(ppo_epoch=2, num_mini_batch=1)
        state = jppo.create_agent_state(jcfg, {"params": _f64(params), "batch_stats": _f64(stats)})
        collect_update = jax.jit(jdr.make_collect_and_update(
            replaying_collect(collects), jppo.make_update_pol(j_policy, jcfg, N, pose_bank=False)))
        carry = carry0()
        buf = jdr.RolloutSepIdx.create(CYCLE * T, N, 2, slab_dtype=jnp.float64)
        key, pol = jax.random.PRNGKey(0), []
        for sub in range(CYCLE):
            scale = jnp.float32(linear_decay(sub, CYCLE))
            state, *carry, slab, losses, _ = collect_update(
                None, state, *carry, jax.random.fold_in(key, 2 * sub),
                jax.random.fold_in(key, 2 * sub + 1), scale, scale)
            buf = jdr.write_sep_slab(buf, slab, sub * T)
            pol.append(np.asarray(losses))
        assert int(carry[0]) == CYCLE
        sep_lrs = jnp.asarray([linear_decay(i, CYCLE) for i in range(CYCLE)], jnp.float32)
        state, sep = jax.jit(jdr.make_update_sep_from_slabs(j_policy, jcfg, N, CYCLE))(
            state, buf, jax.random.fold_in(key, 999), sep_lrs)
    assert_matches(trainer, (np.stack(pol), np.asarray(sep)), state.params, params, stats)

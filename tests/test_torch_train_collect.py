"""The port's collect against the JAX package's on the CPU: one rollout on
the same weights, held to the JAX rollout, its stats and its separator slab
(split from tests/test_torch_train_loop.py, whose tolerances it keeps)."""

import numpy as np

from move2hear_tpu_torch.rl import device_rollout as tdr
from test_torch_train_loop import N, T, SPECTROGRAMS, _close, _warm_torch_cpu_math, collected
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_collect_matches_jax_rollout(collected):
    (j_pol, _, _), ours = collected
    pol = ours.rollouts_pol
    np.testing.assert_array_equal(pol["actions"].numpy(), j_pol["actions"])
    np.testing.assert_array_equal(pol["masks"].numpy(), j_pol["masks"])
    assert j_pol["masks"].min() == 0.0  # the horizon ends inside the rollout
    for k in ("rewards", "value_preds", "returns", "action_log_probs", "hidden",
              "pred_binSepMasks", "pred_mono", "prev_pred_monoFromMem"):
        _close(pol[k], j_pol[k], k, k in SPECTROGRAMS)
    assert set(pol["observations"]) == set(j_pol["observations"])
    for k, v in pol["observations"].items():
        _close(v, j_pol["observations"][k], k, k in SPECTROGRAMS)


def test_collect_matches_jax_stats_and_sep_slab(collected):
    (_, j_stats, j_slab), ours = collected
    assert ours.stats.shape == j_stats.shape == (T, N, len(tdr.STAT_FIELDS) + 3)
    st, j_st = tdr.unpack_stats(ours.stats), tdr.unpack_stats(j_stats)
    for k in st:
        _close(st[k], j_st[k], k)
    # the bonus step (MAX-2) and the episode end both fall inside the rollout
    assert (j_st["done"] == 1.0).any()
    for k, v in ours.sep_slab.items():
        _close(v, j_slab[k], k, k in SPECTROGRAMS)

"""DDPPO on the device path across processes on the CPU: a gloo world of 2
ranks x 4 envs against one rank of 8 envs, the JAX package's tiny run
(tests/test_multihost.py: hidden 32, 2 steps, RIR length 300), on the
dense RIR banks (with 1 and 2 minibatches) and on the RIR sub-banks. Both
ranks end with bitwise equal parameters, and those equal the single
rank's within rtol 1e-4, atol 1e-5:
the world's episode table is sliced by rank, each rank samples its rows of
one global draw, the advantages are normalised over the world and the
gradients summed, so only the order of the float sums differs. The ranks
run as subprocesses of ``tests/_torch_ddppo_rank.py``."""

import shutil

import pytest
import torch

from _torch_ddppo_rank import assert_world_equals_single, finish, launch, launch_world, train_argv
from _torch_threads import cap_torch_threads

cap_torch_threads()


def _load(path):
    return torch.load(path, weights_only=False)


@pytest.mark.parametrize("opts", [
    ["TPU.RIR_MODE", "dense"],
    ["TPU.RIR_MODE", "sub"],
    # each minibatch holds the ranks' members of one global permutation
    ["TPU.RIR_MODE", "dense", "RL.PPO.num_mini_batch", "2", "RL.PPO.ppo_epoch", "2"],
], ids=["dense", "sub", "dense-2-minibatches"])
def test_two_ranks_train_as_one_rank_of_their_envs(tmp_path, opts):
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    procs = launch_world(outs, train_argv(tmp_path / "world", *opts, "NUM_PROCESSES", "4"))
    procs.append(launch(tmp_path / "single.pt", train_argv(tmp_path / "single", *opts,
                                                           "NUM_PROCESSES", "8")))
    logs = finish(procs)
    assert "rank 1 of 2 joined gloo" in logs[1]
    ranks = [_load(o) for o in outs]
    assert all(r["cycles"] == 2 for r in ranks)
    assert_world_equals_single(ranks, _load(tmp_path / "single.pt"))
    shutil.rmtree(tmp_path)  # the checkpoints

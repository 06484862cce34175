"""The passive pretrain across processes on the CPU: a gloo world of 2
ranks x 8 rows against one rank of the 16-row batch, for 2 epochs of 2
steps on 32 synthetic datapoints (the weights in float64, on the float32
render: Adam's eps conditioning parts two float32 runs' updates where a
gradient entry sits near eps). Every rank draws the global batch and takes
its rows, the BatchNorm batch statistics and the gradients are summed over
the world, and the validation batches are split and their losses summed:
both ranks end bitwise equal, and equal to the single rank within rtol
1e-4, atol 1e-5, BatchNorm running statistics included. Beside them, a
single rank's SIGUSR2 after the first epoch saves the interrupted state
(the batch generator and the best validation losses with it), and the next
launch resumes at epoch 1 and ends with the uninterrupted single rank's
parameters."""

import os
import shutil

import torch

from _torch_ddppo_rank import assert_world_equals_single, finish, launch, launch_world, train_argv
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/pretrain_passive.yaml"
ENV = {"M2H_TEST_PASSIVE_POINTS": "32", "M2H_TEST_FLOAT64": "1", "M2H_TEST_THREADS": "2"}
OPTS = ["Pretrain.Passive.NUM_EPOCHS", "2", "Pretrain.Passive.BATCH_SIZE", "16",
        "RL.PPO.ddppo_distrib_backend", "GLOO"]


def _load(path):
    return torch.load(path, weights_only=False)


def test_pretrain_world_trains_as_one_rank_and_resumes(tmp_path):
    env = {**ENV, "INTERRUPTED_STATE_DIR": str(tmp_path / "interrupted")}
    world = [tmp_path / f"rank{r}.pt" for r in range(2)]
    single, sig = tmp_path / "single.pt", tmp_path / "sig.pt"
    sig_argv = train_argv(tmp_path / "sig", *OPTS, exp=EXP)
    procs = launch_world(world, train_argv(tmp_path / "world", *OPTS, exp=EXP), env=env)
    procs.append(launch(single, train_argv(tmp_path / "single", *OPTS, exp=EXP), env=env))
    procs.append(launch(sig, sig_argv, env={**env, "M2H_TEST_SIGNAL": "USR2"}))
    finish(procs)
    ranks = [_load(o) for o in world]
    assert any("running_mean" in k for k in ranks[0]["state_dict"])
    one = _load(single)
    assert_world_equals_single(ranks, one)
    for split in ("val", "nonoverlapping_val"):
        torch.testing.assert_close(torch.tensor(ranks[0]["val_history"][-1][split]),
                                   torch.tensor(one["val_history"][-1][split]),
                                   rtol=1e-4, atol=1e-5)
    assert len(_load(sig)["val_history"]) == 1
    assert len(os.listdir(tmp_path / "interrupted")) == 1

    log, = finish([launch(sig, sig_argv, env=env)])
    assert "resumed the interrupted pretrain at epoch 1" in log
    assert not os.listdir(tmp_path / "interrupted")
    got = _load(sig)["state_dict"]
    for k, v in one["state_dict"].items():
        assert torch.equal(got[k], v), k
    shutil.rmtree(tmp_path)  # the checkpoints

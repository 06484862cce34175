"""Preemption on the CPU: a signal in the middle of a training run saves
the interrupted state at the cycle's end and the run exits cleanly; the
next launch of the experiment resumes at the saved update count and ends
with the parameters of a run that was never interrupted (the device path
saves the world's env carry and the action generator beside the train
state), and the state is removed at its normal end. SIGUSR2 reaches rank 1
of a 2-rank gloo world only (the ranks agree on EXIT at the cycle's end);
SIGUSR1 (exit and requeue) a world of one, with a SLURM job id set. The
runs are the JAX package's tiny run (tests/_torch_ddppo_rank.py)."""

import os
import shutil

import pytest
import torch

from _torch_ddppo_rank import finish, launch, launch_world, train_argv
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("signal_name,ranks", [("USR2", 2), ("USR1", 1)])
def test_signal_saves_and_the_next_launch_resumes_to_the_same_end(tmp_path, signal_name, ranks):
    state_dir = tmp_path / "interrupted"
    env = {"INTERRUPTED_STATE_DIR": str(state_dir), "SLURM_JOB_ID": "4242"}
    argv = train_argv(tmp_path / "run", "NUM_PROCESSES", str(8 // ranks))
    ref_argv = train_argv(tmp_path / "ref", "NUM_PROCESSES", str(8 // ranks))

    def start(tag, args, signal_env=None):
        outs = [tmp_path / f"{tag}{r}.pt" for r in range(ranks)]
        if ranks == 1:
            return outs, [launch(outs[0], args, env={**env, **(signal_env or {})})]
        # the signal reaches the last rank only
        return outs, launch_world(outs, args, env=env, envs={ranks - 1: signal_env or {}})

    ref_outs, ref = start("ref", ref_argv)
    sig_outs, sig = start("sig", argv, {"M2H_TEST_SIGNAL": signal_name})
    logs = finish(ref + sig)[len(ref):]
    assert all(torch.load(o, weights_only=False)["cycles"] == 1 for o in sig_outs)
    saved = os.listdir(state_dir)
    assert len(saved) == 1
    snap = torch.load(state_dir / saved[0], weights_only=True)
    assert snap["extra_state"]["update_count"] == 1 and snap["carry"]["hidden"].shape[0] == 8
    if signal_name == "USR1":
        assert "requeueing SLURM job 4242" in logs[0]

    res_outs, res = start("res", argv)
    logs = finish(res)
    assert all("resumed the interrupted train state at update 1" in log for log in logs)
    assert not os.listdir(state_dir)  # removed at the normal end
    want = torch.load(ref_outs[0], weights_only=False)["state_dict"]
    for out in res_outs:
        got = torch.load(out, weights_only=False)
        assert got["cycles"] == 1
        for k, v in want.items():
            assert torch.equal(got["state_dict"][k], v), k
    shutil.rmtree(tmp_path)  # the checkpoints

"""DDPPO on the host env path across processes on the CPU (in-process
envs, USE_SYNC_VECENV): a gloo world of 2 ranks x 4 envs against one rank
of 8 (the world's scenes or episodes split globally, env i of rank r seeded
SEED + 4r + i), and the per-step preemptive sync with divergent store
reads. The ranks run as subprocesses of ``tests/_torch_ddppo_rank.py``."""

import math
import shutil

import torch

from _torch_ddppo_rank import assert_world_equals_single, finish, launch, launch_world, train_argv
from _torch_threads import cap_torch_threads

cap_torch_threads()

HOST = ["TPU.RIR_MODE", "host", "USE_SYNC_VECENV", "True"]
T, CYCLE, THRESHOLD = 4, 2, 0.5
SYNC = ["RL.PPO.num_steps", str(T), "RL.PPO.num_updates_per_cycle", str(CYCLE),
        "NUM_UPDATES", str(CYCLE), "RL.PPO.short_rollout_threshold", str(THRESHOLD),
        "RL.PPO.sync_frac", "0.5", "NUM_PROCESSES", "2"]


def _load(path):
    return torch.load(path, weights_only=False)


def test_host_path_two_ranks_train_as_one_rank(tmp_path):
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    procs = launch_world(outs, train_argv(tmp_path / "world", *HOST, "NUM_PROCESSES", "4"))
    procs.append(launch(tmp_path / "single.pt", train_argv(tmp_path / "single", *HOST,
                                                           "NUM_PROCESSES", "8")))
    finish(procs)
    assert_world_equals_single([_load(o) for o in outs], _load(tmp_path / "single.pt"))
    shutil.rmtree(tmp_path)  # the checkpoints


def test_host_path_divergent_store_reads_cut_every_rank_alike(tmp_path):
    """Rank 0 reads the world done, rank 1 reads no rank done: the ranks
    agree to cut (collective_any) at ceil(threshold * T) steps, and train
    exactly as two ranks that both read the world done."""
    runs = {}
    procs = []
    for tag, modes in (("stop_go", ("stop", "go")), ("stop_stop", ("stop", "stop"))):
        runs[tag] = [tmp_path / f"{tag}{r}.pt" for r in range(2)]
        procs += launch_world(runs[tag], train_argv(tmp_path / tag, *HOST, *SYNC), envs={
            r: {"M2H_TEST_SYNC_STORE": m} for r, m in enumerate(modes)})
    finish(procs)
    got = {tag: [_load(o) for o in outs] for tag, outs in runs.items()}
    for tag, ranks in got.items():
        assert [r["sep_fill"] for r in ranks] == [CYCLE * math.ceil(THRESHOLD * T)] * 2, tag
    for k, v in got["stop_go"][0]["state_dict"].items():
        for other in (got["stop_go"][1], *got["stop_stop"]):
            assert torch.equal(v, other["state_dict"][k]), k
    shutil.rmtree(tmp_path)

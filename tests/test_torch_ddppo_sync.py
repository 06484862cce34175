"""DDPPO's preemptive rollout sync on the device path on the CPU: in a
gloo world of 2 ranks, divergent store reads (rank 0 reads the world done,
rank 1 no rank) train exactly as agreeing ones. The ranks agree
(``collective_any``) to cut every rollout after its prefix of
ceil(threshold * T) steps, and the refit weighs the cycle *
ceil(threshold * T) rows filled. Under TPU.FUSED_CYCLE or
TPU.PAIRWISE_FUSION, as in the JAX package, no sync is made: the same world
and store keep every rollout whole. The ranks run as subprocesses of
``tests/_torch_ddppo_rank.py``."""

import math
import shutil

import torch

from _torch_ddppo_rank import finish, launch_world, train_argv
from _torch_threads import cap_torch_threads

cap_torch_threads()

T, CYCLE, THRESHOLD = 4, 2, 0.5
S0 = math.ceil(THRESHOLD * T)


def test_divergent_store_reads_cut_every_rank_alike(tmp_path):
    sync = ["RL.PPO.num_steps", str(T), "RL.PPO.num_updates_per_cycle", str(CYCLE),
            "NUM_UPDATES", str(2 * CYCLE), "RL.PPO.short_rollout_threshold", str(THRESHOLD),
            "RL.PPO.sync_frac", "0.5", "NUM_PROCESSES", "4"]
    runs, procs = {}, []
    for tag, modes in (("stop_go", ("stop", "go")), ("stop_stop", ("stop", "stop"))):
        runs[tag] = [tmp_path / f"{tag}{r}.pt" for r in range(2)]
        procs += launch_world(runs[tag], train_argv(tmp_path / tag, *sync), envs={
            r: {"M2H_TEST_SYNC_STORE": m} for r, m in enumerate(modes)})
    finish(procs)
    got = {tag: [torch.load(o, weights_only=False) for o in outs] for tag, outs in runs.items()}
    for tag, ranks in got.items():
        assert [r["sep_fill"] for r in ranks] == [CYCLE * S0] * 2, tag
    for k, v in got["stop_go"][0]["state_dict"].items():
        for other in (got["stop_go"][1], *got["stop_stop"]):
            assert torch.equal(v, other["state_dict"][k]), k
    shutil.rmtree(tmp_path)


def test_a_fusion_knob_keeps_the_worlds_rollouts_whole(tmp_path):
    """A store that reads the world done on both ranks cuts nothing under
    either fusion knob: each rank's refit weighs cycle * T rows, and the
    ranks end bitwise equal."""
    sync = ["RL.PPO.num_steps", str(T), "RL.PPO.num_updates_per_cycle", str(CYCLE),
            "NUM_UPDATES", str(CYCLE), "RL.PPO.short_rollout_threshold", str(THRESHOLD),
            "RL.PPO.sync_frac", "0.5", "NUM_PROCESSES", "2"]
    runs, procs = {}, []
    for knob in ("FUSED_CYCLE", "PAIRWISE_FUSION"):
        runs[knob] = [tmp_path / f"{knob}{r}.pt" for r in range(2)]
        procs += launch_world(runs[knob], train_argv(tmp_path / knob, *sync, f"TPU.{knob}", "True"),
                              env={"M2H_TEST_SYNC_STORE": "stop"})
    finish(procs)
    for knob, outs in runs.items():
        ranks = [torch.load(o, weights_only=False) for o in outs]
        assert [r["sep_fill"] for r in ranks] == [CYCLE * T] * 2, knob
        for k, v in ranks[0]["state_dict"].items():
            assert torch.equal(v, ranks[1]["state_dict"][k]), (knob, k)
    shutil.rmtree(tmp_path)

"""DDPPO's world against a single rank in float64 on the CPU, through the
rank launcher's M2H_TEST_FLOAT64 (the policy, its Adam state and the refit
slabs float64, on the float32 render): a gloo world of 2 ranks x 4 envs
against one rank of 8 envs, one update and refit of the JAX package's tiny
run. chip_smoke.py's ddppo-parity holds this pair at full width on the card
to TRAIN_DP_TOL (3e-4 in norm), because two float32 runs of different batch
shapes can part at a ReLU kink (ROADMAP Queue 3). In float64 each tensor's
parameter change agrees within 1e-9 in norm, and the losses within 1e-6
relative, or over 1e-2 below it (the refit's logged per-step L1s keep
float32 storage; an epoch's action loss is 0 but for rounding)."""

import shutil

import numpy as np
import torch

from _torch_ddppo_rank import TINY_TRAIN, finish, launch, launch_world, train_argv
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/train/nearTarget.yaml"
ONE_UPDATE = ["NUM_UPDATES", "1", "RL.PPO.num_updates_per_cycle", "1"]


def test_float64_world_trains_as_one_rank_of_its_envs(tmp_path):
    env = {"M2H_TEST_FLOAT64": "1"}
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    procs = launch_world(outs, train_argv(tmp_path / "world", *ONE_UPDATE, "NUM_PROCESSES", "4"),
                         env=env)
    procs.append(launch(tmp_path / "single.pt", train_argv(
        tmp_path / "single", *ONE_UPDATE, "NUM_PROCESSES", "8"), env=env))
    finish(procs)
    world = [torch.load(o, weights_only=False) for o in outs]
    single = torch.load(tmp_path / "single.pt", weights_only=False)
    # every run starts from the seeded float32 init
    cfg = get_config(EXP, [*TINY_TRAIN, *ONE_UPDATE], str(tmp_path / "init"), "train")
    start = PPOTrainer(cfg, device="cpu")._new_policy().state_dict()
    moved = 0
    for k, ref in single["state_dict"].items():
        ours = world[0]["state_dict"][k]
        assert torch.equal(ours, world[1]["state_dict"][k]), k
        if not ref.is_floating_point() or "running_" in k:
            continue
        assert ref.dtype == torch.float64, k
        change = ref - start[k].double()
        if change.any():
            moved += 1
            dp = float(torch.linalg.vector_norm(ours - ref) / torch.linalg.vector_norm(change))
            assert dp <= 1e-9, (k, dp)
    assert moved > 10
    (pol, sep), = world[0]["loss_log"]
    (spol, ssep), = single["loss_log"]
    for a, b in ((pol.numpy(), spol.numpy()), (sep.numpy(), ssep.numpy())):
        # relative, but over 1e-2 for a loss below it (an epoch's action
        # loss starts at the mean of normalised advantages, 0 but for rounding)
        assert (np.abs(a - b) <= 1e-6 * np.maximum(np.abs(b), 1e-2)).all(), (a, b)
    shutil.rmtree(tmp_path)

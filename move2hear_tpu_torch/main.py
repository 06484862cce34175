"""CLI entry point of the port (the JAX package's ``main.py``): build the
config, resolve the trainer from the registry, dispatch train/eval.

    python -m move2hear_tpu_torch.main --run-type train \\
        --exp-config configs/pretrain_passive.yaml --model-dir PRE [--device cpu]
    python -m move2hear_tpu_torch.main --run-type eval \\
        --exp-config configs/pretrain_passive.yaml --model-dir PRE \\
        [--device cpu] EVAL_CKPT_PATH_DIR PRE/data
    python -m move2hear_tpu_torch.main --run-type train \\
        --exp-config configs/train/nearTarget.yaml --model-dir DIR [--device cpu] \\
        RL.PPO.pretrained_passive_separators_ckpt PRE/data/best_ckpt_nonoverlapping_val.pth
    python -m move2hear_tpu_torch.main --run-type eval \\
        --exp-config configs/test/nearTarget.yaml --model-dir DIR \\
        [--device cpu] EVAL_CKPT_PATH_DIR DIR/data/ckpt.N.pth
    python -m move2hear_tpu_torch.main --run-type train \\
        --exp-config configs/train/farTarget.yaml --model-dir FAR [--device cpu] \\
        RL.PPO.pretrained_passive_separators_ckpt PRE/data/best_ckpt_nonoverlapping_val.pth
    python scripts/torch_merge_switch_ckpt.py FAR/data/ckpt.N.pth \\
        DIR/data/ckpt.M.pth SWITCH.pth
    python -m move2hear_tpu_torch.main --run-type eval \\
        --exp-config configs/test/farTarget.yaml --model-dir EV [--device cpu] \\
        EVAL_CKPT_PATH_DIR SWITCH.pth

A reference checkpoint is converted first, with
``scripts/torch_import_ref_ckpt.py IN.pth OUT.pth``.

Training runs as a DDPPO world of ranks when launched by ``torchrun
--nproc-per-node R -m move2hear_tpu_torch.main --run-type train ...`` or
with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT (or SLURM's
variables) set for each process; RL.PPO.ddppo_distrib_backend picks NCCL
(the default, one GPU a rank) or GLOO. Each rank runs on ``cuda:LOCAL_RANK``
unless ``--device`` names another device. ``--report FILE`` writes a JSON
summary of the run (``{rank}`` in FILE becomes the rank).

It runs on ``cuda`` unless ``--device cpu`` is given, and never falls back
on its own.
"""

import argparse
import hashlib
import json
import logging
import signal

import torch

from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.parallel.ddppo import add_signal_handlers, init_distributed
from move2hear_tpu_torch.pretrain import trainer as _pretrain  # noqa: F401  registers "passive"
from move2hear_tpu_torch.rl import trainer as _trainers  # noqa: F401  registers "ppo"
from move2hear_tpu_torch.utils.registry import registry


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--run-type", choices=["train", "eval"], default="train",
        help="run type of the experiment (train or eval)",
    )
    parser.add_argument("--exp-config", type=str, default=None,
                        help="path to experiment config yaml")
    parser.add_argument("--model-dir", default=None, help="output dir")
    parser.add_argument("--eval-interval", type=int, default=1,
                        help="evaluation interval of checkpoints")
    parser.add_argument("--prev-ckpt-ind", type=int, default=-1,
                        help="index of the last evaluated checkpoint")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (cuda, cuda:N or cpu; default cuda, "
                             "cuda:LOCAL_RANK in a world of ranks)")
    parser.add_argument("--report", default=None,
                        help="write a JSON summary of the run to this file ({rank} is "
                             "replaced by the rank)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted-key config overrides")
    args = parser.parse_args(argv)

    config = get_config(args.exp_config, args.opts, args.model_dir, args.run_type)
    trainer_cls = registry.get_trainer(config.TRAINER_NAME)
    if trainer_cls is None:
        raise ValueError(f"{config.TRAINER_NAME} is not supported by the port")

    logging.basicConfig(
        level=logging.DEBUG if config.DEBUG else logging.INFO,
        format="%(asctime)s, %(levelname)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    # the world's rendezvous before the trainer touches a device, then the
    # preemption signals (SIGINT, SIGTERM, SIGUSR2: save and exit; SIGUSR1:
    # also requeue); evaluation stays one process
    ppo = config.RL.PPO
    local_rank, rank, ranks = 0, 0, 1
    previous = {}
    if args.run_type == "train":
        local_rank, rank, ranks = init_distributed(ppo.ddppo_distrib_backend, ppo.master_addr,
                                                   ppo.master_port)
        previous = add_signal_handlers()
    device = args.device or ("cuda" if ranks == 1 else f"cuda:{local_rank}")
    if torch.device(device).index is not None and torch.cuda.is_available():
        torch.cuda.set_device(torch.device(device))
    logging.getLogger(__name__).info("rank %d of %d on %s, signal handlers set", rank, ranks,
                                     device)
    try:
        trainer = trainer_cls(config, device=device)
        if args.run_type == "train":
            trainer.train()
        else:
            trainer.eval(args.eval_interval, args.prev_ckpt_ind)
    finally:
        # a caller that runs main in its own process keeps its handlers
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if args.report:
        write_report(args.report.replace("{rank}", str(rank)), trainer, device, rank, ranks)
    return trainer


def write_report(path: str, trainer, device: str, rank: int, ranks: int) -> None:
    """The run's summary as JSON: rank and world, the trainer's logs (set-up
    seconds, per-cycle or per-epoch seconds and losses), the kernels'
    launch counts, the collectives' totals, the peak device memory, and the
    SHA-256 of the final weights (rank order of the state dict's bytes)."""
    from move2hear_tpu_torch.ops.kernels import launch_counts
    from move2hear_tpu_torch.parallel.dist import COMM

    policy = getattr(trainer, "final_policy", None)
    digest = None
    if policy is not None:
        h = hashlib.sha256()
        for v in policy.state_dict().values():
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
        digest = h.hexdigest()
    on_cuda = torch.device(device).type == "cuda"
    report = {
        "rank": rank, "world": ranks, "device": device,
        "setup_s": getattr(trainer, "setup_s", None),
        "cycle_log": getattr(trainer, "cycle_log", None),
        "epoch_log": getattr(trainer, "epoch_log", None),
        "loss_log": [[pol.tolist(), sep.tolist()] for pol, sep in getattr(trainer, "loss_log", [])],
        "sep_fill": getattr(trainer, "_last_sep_fill", None),
        "launches": launch_counts(), "comm": dict(COMM),
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if on_cuda else None,
        "params_sha256": digest,
    }
    with open(path, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()

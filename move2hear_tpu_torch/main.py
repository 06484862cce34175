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

It runs on ``cuda`` unless ``--device cpu`` is given, and never falls back
on its own.
"""

import argparse
import logging

from move2hear_tpu_torch.config import get_config
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
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
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
    trainer = trainer_cls(config, device=args.device)
    if args.run_type == "train":
        trainer.train()
    else:
        trainer.eval(args.eval_interval, args.prev_ckpt_ind)
    return trainer


if __name__ == "__main__":
    main()

"""Trainer base with the checkpoint-polling eval loop
(``audio_separation/common/base_trainer.py``)."""

import logging
import os
import time

from move2hear_tpu_torch.parallel.ddppo import clear_interrupted_state
from move2hear_tpu_torch.utils.config_tree import Config
from move2hear_tpu_torch.utils.misc import poll_checkpoint_folder


class BaseRLTrainer:
    def __init__(self, config):
        self.config = config

    def train(self) -> None:
        raise NotImplementedError

    def eval(self, eval_interval: int = 1, prev_ckpt_ind: int = -1) -> None:
        """Single-checkpoint eval when EVAL_CKPT_PATH_DIR is a file;
        otherwise poll the folder forever, evaluating each new checkpoint in
        mtime order (base_trainer.py:59-102)."""
        ckpt_dir = self.config.EVAL_CKPT_PATH_DIR
        if os.path.isfile(ckpt_dir):
            self._eval_checkpoint(ckpt_dir, checkpoint_index=0)
            return
        while True:
            current_ckpt = None
            while current_ckpt is None:
                current_ckpt = poll_checkpoint_folder(ckpt_dir, prev_ckpt_ind, eval_interval)
                if current_ckpt is None:
                    if getattr(self, "_eval_poll_once", False):
                        return
                    time.sleep(2)
            prev_ckpt_ind += eval_interval
            self._eval_checkpoint(checkpoint_path=current_ckpt, checkpoint_index=prev_ckpt_ind)

    def _eval_checkpoint(self, checkpoint_path: str, checkpoint_index: int = 0) -> None:
        raise NotImplementedError

    def _interrupt_scope(self) -> str:
        """Keys the preemption snapshot to this experiment (trainer kind and
        checkpoint folder), the JAX package's scope string, so runs sharing
        the default JOB_ID do not adopt each other's state."""
        return f"{type(self).__name__}:{self.config.CHECKPOINT_FOLDER}"

    def _clear_interrupted_state(self) -> None:
        """Remove this experiment's snapshot after a run that ended normally
        (nothing after a preemption signal, or on a rank other than 0)."""
        clear_interrupted_state(self.config.JOB_ID, self._interrupt_scope())

    @staticmethod
    def _setup_eval_config(checkpoint_config, eval_config):
        """Merge priority: eval CLI opts > ckpt CLI opts > eval cfg > ckpt cfg
        (base_trainer.py:104-140). Falls back to the eval config alone when
        the saved config is outdated (missing or renamed keys)."""
        ckpt_dict = checkpoint_config if isinstance(checkpoint_config, dict) else {}
        eval_dict = (
            eval_config.to_dict() if isinstance(eval_config, Config) else dict(eval_config)
        )
        ckpt_opts = list(ckpt_dict.get("CMD_TRAILING_OPTS") or [])
        eval_opts = list(eval_dict.get("CMD_TRAILING_OPTS") or [])

        merged = Config(ckpt_dict)
        merged.merge_from_other(eval_dict)
        try:
            merged.merge_from_list(ckpt_opts)
            merged.merge_from_list(eval_opts)
        except (KeyError, ValueError):
            logging.getLogger(__name__).info(
                "Saved config is outdated, using solely eval config"
            )
            merged = Config(eval_dict)
            if eval_opts:
                merged.merge_from_list(eval_opts)
        return merged.freeze()

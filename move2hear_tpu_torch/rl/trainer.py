"""The PPO trainer's eval surface: checkpoint evaluation on the device
route (``rl/trainer.py:_eval_checkpoint`` of the JAX package). Training,
the host evaluator and file-backed scene data are not ported yet and raise
NotImplementedError."""

import logging
import os

from move2hear_tpu_torch.env.device_env import estimate_bank_bytes
from move2hear_tpu_torch.eval.device_evaluator import evaluate_checkpoint_device
from move2hear_tpu_torch.rl.base_trainer import BaseRLTrainer
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from move2hear_tpu_torch.utils.registry import registry

logger = logging.getLogger(__name__)


def has_file_backed_data(task_config) -> bool:
    """True when episode files AND scene metadata exist on disk."""
    d = task_config.DATASET
    data_path = d.DATA_PATH.format(version=d.VERSION, split=d.SPLIT)
    content_dir = os.path.join(os.path.dirname(data_path), "content")
    has_episodes = os.path.isfile(data_path) or (
        os.path.isdir(content_dir)
        and any(f.endswith(".json.gz") for f in os.listdir(content_dir))
    )
    return has_episodes and os.path.isdir(task_config.SIMULATOR.AUDIO.META_DIR)


@registry.register_trainer(name="ppo")
class PPOTrainer(BaseRLTrainer):
    def __init__(self, config, bundle=None, device="cuda"):
        super().__init__(config)
        self._bundle = bundle
        self.device = device
        self.last_eval = None  # (aggregates, timings) of the last checkpoint

    def _eval_checkpoint(self, checkpoint_path: str, checkpoint_index: int = 0):
        """Merge the checkpoint's saved config per EVAL.USE_CKPT_CONFIG
        (switch-policy eval reads the nav policy's config), then run the
        batched device evaluator."""
        cfg = self.config
        ckpt = load_checkpoint(checkpoint_path)
        if cfg.RL.PPO.switch_policy:
            nav_cfg = ckpt.get("config_nav")
            config = self._setup_eval_config(nav_cfg, cfg) if nav_cfg else cfg
        elif cfg.EVAL.USE_CKPT_CONFIG and ckpt.get("config"):
            config = self._setup_eval_config(ckpt["config"], cfg)
        else:
            config = cfg

        bundle = self._bundle
        if bundle is None and has_file_backed_data(config.TASK_CONFIG):
            raise NotImplementedError(
                "file-backed scene data is not ported yet; the port evaluates "
                "on the synthetic micro-scene"
            )
        n_eps = config.get("EVAL_EPISODE_COUNT", config.EVAL.EPISODE_COUNT)
        use_device = (
            config.TPU.DEVICE_ENV
            and n_eps >= config.TPU.DEVICE_EVAL_MIN_EPISODES
        )
        if use_device and bundle is not None:
            use_device = estimate_bank_bytes(bundle) <= int(config.TPU.MAX_DEVICE_BANK_BYTES)
        if not use_device:
            raise NotImplementedError(
                "the host evaluator (small episode counts, banks over "
                "TPU.MAX_DEVICE_BANK_BYTES) is not ported yet"
            )
        timings = {}
        agg = evaluate_checkpoint_device(
            config, checkpoint_path, checkpoint_index, bundle=bundle,
            device=self.device, timings=timings,
        )
        self.last_eval = (agg, timings)
        logger.info(
            "checkpoint %d: %d episodes, %d env-steps in %.3f s (set-up %.3f s)",
            checkpoint_index, timings["episodes"], timings["env_steps"],
            timings["loop_s"], timings["setup_s"],
        )
        return agg

from move2hear_tpu_torch.config.default import default_config, get_config, get_task_config

__all__ = ["get_config", "get_task_config", "default_config"]

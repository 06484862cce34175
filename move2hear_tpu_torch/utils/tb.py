"""TensorBoard writer (``common/tensorboard_utils.py``): a SummaryWriter
wrapper that does nothing when the log dir is empty or when
``torch.utils.tensorboard`` cannot be imported (it needs the
``tensorboard`` package)."""


class TensorboardWriter:
    def __init__(self, log_dir: str, *args, **kwargs):
        self.writer = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(log_dir, *args, **kwargs)

    def __getattr__(self, item):
        if self.writer:
            return getattr(self.writer, item)
        return lambda *args, **kwargs: None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        if self.writer:
            self.writer.close()

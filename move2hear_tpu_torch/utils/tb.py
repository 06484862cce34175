"""TensorBoard writer (``common/tensorboard_utils.py``): a SummaryWriter
wrapper that does nothing when the log dir is empty or when
``torch.utils.tensorboard`` cannot be imported (it needs the
``tensorboard`` package), with the reference's video-from-frames helper
(tensorboard_utils.py:36-62)."""

import numpy as np


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

    def add_video_from_np_images(self, video_name: str, step_idx: int, images,
                                 fps: int = 10) -> None:
        """images: a list of (H, W, 3) uint8 frames."""
        if not self.writer:
            return
        import torch

        frames = np.stack(images)  # (T, H, W, 3)
        video = torch.from_numpy(frames.transpose(0, 3, 1, 2)[None])  # (1, T, C, H, W)
        self.writer.add_video(video_name, video, step_idx, fps=fps)

"""RGB/depth encoder CNN for the policy (the reference's
``rl/models/visual_cnn.py``): 3 convs (8x8/s4, 4x4/s2, 3x3/s1, no padding,
channels 32/64/32; ReLU after the first two only) + Linear -> output_size +
ReLU. RGB is scaled by 1/255; rgb and depth are concatenated on channels.
``extra_rgb`` / ``extra_depth`` leave a modality out of the encoding.
Frames arrive NHWC (B, H, W, C), as the frame banks store them. `dtype` is
the compute dtype: the frames are cast to it and RGB divided by 255 in it,
as the JAX package's ``rgb.astype(dtype) / 255.0``, and the layers run in
it (``models/unet.py``)."""

import torch
from torch import nn

from move2hear_tpu_torch.models.unet import Conv2d, Linear, init_dense_


class VisualCNN(nn.Module):
    def __init__(
        self, output_size: int = 512, extra_rgb: bool = False,
        extra_depth: bool = False, image_size: int = 128, generator=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.extra_rgb = extra_rgb
        self.extra_depth = extra_depth
        self.dtype = dtype
        in_ch = (0 if extra_rgb else 3) + (0 if extra_depth else 1)
        side = ((image_size - 8) // 4 + 1 - 4) // 2 + 1 - 2
        self.cnn = nn.Sequential(
            Conv2d(in_ch, 32, 8, stride=4, compute_dtype=dtype), nn.ReLU(),
            Conv2d(32, 64, 4, stride=2, compute_dtype=dtype), nn.ReLU(),
            Conv2d(64, 32, 3, stride=1, compute_dtype=dtype),
            nn.Flatten(),
            Linear(32 * side * side, output_size, compute_dtype=dtype), nn.ReLU(),
        )
        for layer in self.cnn:
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                init_dense_(layer, generator)

    def forward(self, rgb: torch.Tensor = None, depth: torch.Tensor = None):
        inputs = []
        if rgb is not None and not self.extra_rgb:
            inputs.append(rgb.to(self.dtype) / 255.0)
        if depth is not None and not self.extra_depth:
            inputs.append(depth.to(self.dtype))
        if not inputs:
            raise ValueError("VisualCNN called with no modality to encode")
        x = torch.cat(inputs, dim=-1).permute(0, 3, 1, 2)
        return self.cnn(x)

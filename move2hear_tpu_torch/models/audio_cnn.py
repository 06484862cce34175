"""Audio spectrogram encoder CNN for the policy (the reference's
``rl/models/audio_cnn.py``): 3 convs (8x8/s4, 4x4/s2, 2x2/s1, no padding,
channels 32/64/32, ReLU after each) + Linear -> output_size + ReLU, over
16-sliced spectrograms (32 channels, 32x32 -> 7 -> 2 -> 1).

Input modes: bin mode ``log1p(clamp(mask * expm1(mix), 0))`` through the
``masked_mix_slice16`` kernel; monoNmonoFromMem mode
``log1p(clamp(concat(pred_mono, pred_monoFromMem), 0))``. `dtype` is the
compute dtype of the convolutions and the dense layer (``models/unet.py``).
"""

import torch
from torch import nn

from move2hear_tpu_torch.models.unet import Conv2d, Linear, init_dense_
from move2hear_tpu_torch.ops.kernels import masked_mix_slice16
from move2hear_tpu_torch.ops.spec import slice16_nchw


class AudioCNN(nn.Module):
    def __init__(self, output_size: int = 512, encode_mono_n_mono_from_mem: bool = False,
                 generator=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encode_mono_n_mono_from_mem = encode_mono_n_mono_from_mem
        self.cnn = nn.Sequential(
            Conv2d(32, 32, 8, stride=4, compute_dtype=dtype), nn.ReLU(),
            Conv2d(32, 64, 4, stride=2, compute_dtype=dtype), nn.ReLU(),
            Conv2d(64, 32, 2, stride=1, compute_dtype=dtype), nn.ReLU(),
            nn.Flatten(),
            Linear(32, output_size, compute_dtype=dtype), nn.ReLU(),
        )
        for layer in self.cnn:
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                init_dense_(layer, generator)

    def forward(
        self,
        mixed_log_mag: torch.Tensor = None,
        pred_bin_sep_masks: torch.Tensor = None,
        pred_mono_n_mono_from_mem: torch.Tensor = None,
    ):
        if self.encode_mono_n_mono_from_mem:
            x = slice16_nchw(torch.log1p(torch.clamp(pred_mono_n_mono_from_mem, min=0)))
        else:
            x = masked_mix_slice16(mixed_log_mag.contiguous(), pred_bin_sep_masks.contiguous())
        return self.cnn(x)

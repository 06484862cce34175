"""Map the JAX package's flax parameter trees onto this port's state dicts.

Input: ``params`` and ``batch_stats`` as nested dicts of numpy arrays (the
flax names: ``UNetConvBlock_i/Conv_0/kernel``, ``BatchNorm_0/scale``, ...).
Output: ``{state_dict key: torch.Tensor}`` for ``Move2HearPolicy`` or one of
its modules. Layout changes:

  - Conv kernels HWIO -> OIHW;
  - ConvTranspose kernels (kh, kw, in, out) -> torch's (in, out, kh, kw) with
    the spatial taps flipped (flax's transpose-of-correlation with padding 2
    equals torch's ConvTranspose2d(4, 2, 1) on the flipped kernel);
  - Dense (in, out) -> Linear (out, in); where the input is a flattened conv
    map, the input dimension is reordered from NHWC's (H, W, C) to NCHW's
    (C, H, W);
  - GRU packs (D, 3H) -> torch's (3H, D), same r, z, n gate order;
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    # a C-ordered copy: flax arrays are read-only and flipped views have
    # negative strides
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _conv_t(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1)))


def _linear(kernel, in_hwc: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    w = np.asarray(kernel).T  # (out, in), in ordered (H, W, C)
    if in_hwc is not None:
        h, wd, c = in_hwc
        w = w.reshape(w.shape[0], h, wd, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
    return _t(w)


def _bn(params, stats, prefix: str) -> StateDict:
    return {
        prefix + "weight": _t(params["scale"]),
        prefix + "bias": _t(params["bias"]),
        prefix + "running_mean": _t(stats["mean"]),
        prefix + "running_var": _t(stats["var"]),
        prefix + "num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def unet_encoder(params, stats) -> StateDict:
    sd = {}
    for i in range(5):
        blk = f"UNetConvBlock_{i}"
        sd[f"cnn.{i}.0.weight"] = _conv(params[blk]["Conv_0"]["kernel"])
        sd.update(_bn(params[blk]["BatchNorm_0"], stats[blk]["BatchNorm_0"], f"cnn.{i}.1."))
    return sd


def unet_decoder(params, stats) -> StateDict:
    sd = {}
    for i in range(5):
        blk = f"UNetUpConvBlock_{i}"
        sd[f"cnn.{i}.0.weight"] = _conv_t(params[blk]["ConvTranspose_0"]["kernel"])
        sd.update(_bn(params[blk]["BatchNorm_0"], stats[blk]["BatchNorm_0"], f"cnn.{i}.1."))
    sd["cnn.5.0.weight"] = _conv(params["Conv_0"]["kernel"])
    sd["cnn.5.0.bias"] = _t(params["Conv_0"]["bias"])
    return sd


def acoustic_mem(params, stats) -> StateDict:
    """BatchNorm present (cnn.0 conv, cnn.1 BN, cnn.3 conv) iff the tree
    has one; otherwise cnn.0 and cnn.2 are the convs."""
    sd = {"cnn.0.weight": _conv(params["Conv_0"]["kernel"])}
    if "BatchNorm_0" in params:
        sd.update(_bn(params["BatchNorm_0"], stats["BatchNorm_0"], "cnn.1."))
        sd["cnn.3.weight"] = _conv(params["Conv_1"]["kernel"])
    else:
        sd["cnn.2.weight"] = _conv(params["Conv_1"]["kernel"])
    return sd


def _conv_stack(params, dense_index: int, in_hwc) -> StateDict:
    sd = {}
    for i in range(3):
        sd[f"cnn.{2 * i}.weight"] = _conv(params[f"Conv_{i}"]["kernel"])
        sd[f"cnn.{2 * i}.bias"] = _t(params[f"Conv_{i}"]["bias"])
    sd[f"cnn.{dense_index}.weight"] = _linear(params["Dense_0"]["kernel"], in_hwc)
    sd[f"cnn.{dense_index}.bias"] = _t(params["Dense_0"]["bias"])
    return sd


def audio_cnn(params) -> StateDict:
    """The conv map before the Dense is 1x1x32, so no flatten reorder."""
    return _conv_stack(params, 7, None)


def visual_cnn(params) -> StateDict:
    """The Dense reads a (12, 12, 32) map for 128x128 frames."""
    k = np.asarray(params["Dense_0"]["kernel"])
    side = int(round((k.shape[0] // 32) ** 0.5))
    return _conv_stack(params, 6, (side, side, 32))


def gru(params) -> StateDict:
    return {
        "rnn.weight_ih_l0": _t(np.asarray(params["weight_ih"]).T),
        "rnn.weight_hh_l0": _t(np.asarray(params["weight_hh"]).T),
        "rnn.bias_ih_l0": _t(params["bias_ih"]),
        "rnn.bias_hh_l0": _t(params["bias_hh"]),
    }


def _dense(params, prefix: str) -> StateDict:
    return {
        prefix + "weight": _linear(params["Dense_0"]["kernel"]),
        prefix + "bias": _t(params["Dense_0"]["bias"]),
    }


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {prefix + k: v for k, v in sd.items()}


def from_jax(params, batch_stats=None) -> StateDict:
    """The flax tree of ``move2hear_tpu.models.Move2HearPolicy`` -> the
    state dict of ``move2hear_tpu_torch.models.Move2HearPolicy``; a tree of
    the passive pretrain's policy (the four separator subtrees only) -> that
    of ``Move2HearPassiveWoMemoryPolicy``. The flax tree has no
    ``num_batches_tracked``; it maps to 0."""
    stats = batch_stats or {}
    sd: StateDict = {}
    if "pol_net" in params:
        pol = params["pol_net"]
        if "visual_encoder" in pol:
            sd.update(_prefixed("pol_net.visual_encoder.", visual_cnn(pol["visual_encoder"])))
        sd.update(_prefixed("pol_net.bin_encoder.", audio_cnn(pol["bin_encoder"])))
        sd.update(_prefixed(
            "pol_net.monoNmonoFromMem_encoder.", audio_cnn(pol["monoNmonoFromMem_encoder"])
        ))
        sd.update(_prefixed("pol_net.state_encoder.", gru(pol["state_encoder"])))
        sd.update(_dense(params["action_dist"], "action_dist.linear."))
        sd.update(_dense(params["critic"], "critic.fc."))
    for name in ("binSep_enc", "bin2mono_enc"):
        sd.update(_prefixed(f"{name}.", unet_encoder(params[name], stats[name])))
    for name in ("binSep_dec", "bin2mono_dec"):
        sd.update(_prefixed(f"{name}.", unet_decoder(params[name], stats[name])))
    if "acoustic_mem" in params:
        sd.update(_prefixed(
            "acoustic_mem.", acoustic_mem(params["acoustic_mem"], stats.get("acoustic_mem", {}))
        ))
    return sd

"""The passive U-Nets and the passive policy in bfloat16 against the JAX
package's flax modules on the CPU, under tests/test_torch_bf16_models.py's
discriminator (split from it)."""

import jax.numpy as jnp
import pytest
import torch

from move2hear_tpu.models import policy as j_policy
from move2hear_tpu.models import unet as j_unet
from move2hear_tpu_torch.models import (
    Move2HearPassiveWoMemoryPolicy,
    PassiveSepDecoder,
    PassiveSepEncoder,
)
from move2hear_tpu_torch.utils import params as P
from test_torch_bf16_models import (
    BF16,
    _both,
    _init,
    _nchw,
    _np,
    _precise_matmuls_and_plain_route,
    _spec_inputs,
    _variables,
    discriminate,
)
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("bin2mono", [False, True], ids=["binSep", "bin2mono"])
def test_unet_in_bfloat16(bin2mono):
    """Encoder (convs in bf16, BatchNorm in f32) then decoder on the JAX
    bfloat16 encoder's outputs, both U-Net variants; the bin2mono encoder
    takes a bfloat16 mask, as the separator chain hands it on."""
    mix, masks, tc = _spec_inputs(10 + bin2mono)
    jm = jnp.asarray(masks).astype(jnp.bfloat16)
    kw = {"pred_bin_sep_masks": jm} if bin2mono else {"target_class": jnp.asarray(tc)}
    ep, es = _init(j_unet.PassiveSepEncoder(convert_bin2mono=bin2mono), 1, jnp.asarray(mix), **kw)
    (jb_bott, jb_skips), (jf_bott, jf_skips) = _both(
        lambda dt: j_unet.PassiveSepEncoder(convert_bin2mono=bin2mono, dtype=dt),
        lambda m: m.apply(_variables(ep, es), jnp.asarray(mix), **kw))
    enc = PassiveSepEncoder(bin2mono, dtype=BF16)
    enc.load_state_dict(P.unet_encoder(ep, es))
    t_kw = ({"pred_bin_sep_masks": torch.from_numpy(masks).to(BF16)} if bin2mono
            else {"target_class": torch.from_numpy(tc)})
    with torch.no_grad():
        bott, skips = enc.eval()(torch.from_numpy(mix), **t_kw)
    assert bott.dtype == torch.float32 and all(s.dtype == torch.float32 for s in skips)
    discriminate(bott, jb_bott, jf_bott, "bottleneck")
    for i, (s, b, f) in enumerate(zip(skips, jb_skips, jf_skips)):
        discriminate(s.permute(0, 2, 3, 1), b, f, f"skip {i}")

    dp, ds = _init(j_unet.PassiveSepDecoder(convert_bin2mono=bin2mono), 2, jb_bott, jb_skips)
    jb_out, jf_out = _both(
        lambda dt: j_unet.PassiveSepDecoder(convert_bin2mono=bin2mono, dtype=dt),
        lambda m: m.apply(_variables(dp, ds), jb_bott, jb_skips))
    assert jb_out.dtype == jnp.bfloat16
    dec = PassiveSepDecoder(bin2mono, dtype=BF16)
    dec.load_state_dict(P.unet_decoder(dp, ds))
    with torch.no_grad():
        out = dec.eval()(torch.from_numpy(_np(jb_bott)), [_nchw(s) for s in jb_skips])
    assert out.dtype == BF16
    discriminate(out, jb_out, jf_out, "decoder")


def test_passive_policy_in_bfloat16():
    """The pretrain's passive policy on its running statistics: both
    outputs in bfloat16; the bin2mono pair takes the JAX bfloat16 masks, as
    in test_policy_act_in_bfloat16."""
    mix, _, tc = _spec_inputs(90)
    obs = {"mixed_bin_audio_mag": jnp.asarray(mix), "target_class": jnp.asarray(tc)}
    J = j_policy.Move2HearPassiveWoMemoryPolicy
    p, s = _init(J(), 11, obs)
    jb_m, jf_m = _both(lambda dt: J(dtype=dt), lambda m: m.apply(
        _variables(p, s), obs, method=J.get_binSepMasks))
    jb_mono, jf_mono = _both(lambda dt: J(dtype=dt), lambda m: m.apply(
        _variables(p, s), jb_m.astype(m.dtype), obs["mixed_bin_audio_mag"],
        method=J.convert_bin2mono))
    t = Move2HearPassiveWoMemoryPolicy(dtype=BF16)
    t.load_state_dict(P.from_jax(p, s))
    t_obs = {"mixed_bin_audio_mag": torch.from_numpy(mix), "target_class": torch.from_numpy(tc)}
    with torch.no_grad():
        masks = t.eval().get_binSepMasks(t_obs)
        mono = t.convert_bin2mono(torch.from_numpy(_np(jb_m)).to(BF16),
                                  t_obs["mixed_bin_audio_mag"])
        both = t(t_obs)
    assert masks.dtype == mono.dtype == BF16 and torch.equal(both[0], masks)
    discriminate(masks, jb_m, jf_m, "masks")
    discriminate(mono, jb_mono, jf_mono, "mono")

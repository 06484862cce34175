"""The port's models against the JAX package's flax modules on the CPU: the
same flax parameters go to JAX and, through ``utils/params.py``, to the
port; outputs must agree within the tolerances of tests/test_torch_oracle.py
(atol 2e-3, rtol 1e-3). BatchNorm statistics and biases are drawn from a
numpy seed so the layout maps are exercised with non-trivial values. One
family is also held against the reference's own torch outputs
(tests/fixtures/torch_oracle.npz) through ``synth_state_dict``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.models import audio_cnn as j_audio
from move2hear_tpu.models import memory as j_memory
from move2hear_tpu.models import policy as j_policy
from move2hear_tpu.models import rnn as j_rnn
from move2hear_tpu.models import unet as j_unet
from move2hear_tpu.models import visual_cnn as j_visual
from move2hear_tpu_torch.models import (
    AcousticMem,
    AudioCNN,
    GRUStateEncoder,
    Move2HearPolicy,
    PassiveSepDecoder,
    PassiveSepEncoder,
    VisualCNN,
)
from move2hear_tpu_torch.utils import params as P
from _torch_threads import cap_torch_threads

cap_torch_threads()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from torch_oracle_synth import synth_state_dict  # noqa: E402

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "torch_oracle.npz")
B = 2


@pytest.fixture(autouse=True)
def _precise_matmuls():
    # XLA-CPU matmuls default to reduced precision here; compare in real f32
    with jax.default_matmul_precision("highest"):
        yield


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(
        ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours),
        np.asarray(ref), atol=2e-3, rtol=1e-3, err_msg=msg,
    )


def _np_tree(tree, rng):
    """flax variables -> nested numpy dicts, with biases, BatchNorm affine
    parameters and running statistics redrawn from `rng`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _np_tree(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if k == "mean" or k == "bias":
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "var":
            a = (0.5 + rng.uniform(0.0, 1.0, a.shape)).astype(np.float32)
        elif k == "scale":
            a = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def _init(module, seed, *args, **kwargs):
    v = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    rng = np.random.default_rng(seed)
    return _np_tree(v["params"], rng), _np_tree(v.get("batch_stats", {}), rng)


def _variables(params, stats):
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _load(module, sd):
    module.load_state_dict(sd)  # strict: every key mapped, nothing extra
    return module.eval()


def _spec_inputs(seed):
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((B, 512, 32, 2))).astype(np.float32)
    masks = rng.uniform(-0.2, 1.2, (B, 512, 32, 2)).astype(np.float32)
    tc = rng.integers(0, 10, (B, 1)).astype(np.int32)
    return mix, masks, tc


def _nchw(x):
    return torch.tensor(np.transpose(np.asarray(x), (0, 3, 1, 2)))


@pytest.mark.parametrize("bin2mono", [False, True], ids=["binSep", "bin2mono"])
def test_unet_matches_jax(bin2mono):
    mix, masks, tc = _spec_inputs(10 + bin2mono)
    kw = {"pred_bin_sep_masks": jnp.asarray(masks)} if bin2mono else {"target_class": jnp.asarray(tc)}
    enc = j_unet.PassiveSepEncoder(convert_bin2mono=bin2mono)
    ep, es = _init(enc, 1, jnp.asarray(mix), **kw)
    bott, skips = enc.apply(_variables(ep, es), jnp.asarray(mix), **kw)

    t_enc = _load(PassiveSepEncoder(bin2mono), P.unet_encoder(ep, es))
    t_kw = ({"pred_bin_sep_masks": torch.tensor(masks)} if bin2mono
            else {"target_class": torch.tensor(tc)})
    with torch.no_grad():
        t_bott, t_skips = t_enc(torch.tensor(mix), **t_kw)
    _close(t_bott, bott, "bottleneck")
    for i, (s, r) in enumerate(zip(t_skips, skips)):
        _close(s.permute(0, 2, 3, 1), r, f"skip {i}")

    dec = j_unet.PassiveSepDecoder(convert_bin2mono=bin2mono)
    dp, ds = _init(dec, 2, bott, skips)
    out = dec.apply(_variables(dp, ds), bott, skips)
    t_dec = _load(PassiveSepDecoder(bin2mono), P.unet_decoder(dp, ds))
    with torch.no_grad():
        t_out = t_dec(torch.tensor(np.asarray(bott)), [_nchw(s) for s in skips])
    assert t_out.shape == out.shape == (B, 512, 32, 1 if bin2mono else 2)
    _close(t_out, out, "decoder")


@pytest.mark.parametrize("use_ddppo", [True, False], ids=["ddppo", "batchnorm"])
def test_acoustic_mem_matches_jax(use_ddppo):
    rng = np.random.default_rng(20)
    mono = rng.standard_normal((B, 512, 32, 1)).astype(np.float32)
    prev = rng.standard_normal((B, 512, 32, 1)).astype(np.float32)
    mod = j_memory.AcousticMem(use_ddppo=use_ddppo)
    p, s = _init(mod, 3, jnp.asarray(mono), jnp.asarray(prev))
    assert ("BatchNorm_0" in p) == (not use_ddppo)
    out = mod.apply(_variables(p, s), jnp.asarray(mono), jnp.asarray(prev))
    t = _load(AcousticMem(use_ddppo), P.acoustic_mem(p, s))
    with torch.no_grad():
        _close(t(torch.tensor(mono), torch.tensor(prev)), out)


@pytest.mark.parametrize("mono_mode", [False, True], ids=["bin", "monoNmonoFromMem"])
def test_audio_cnn_matches_jax(mono_mode):
    mix, masks, _ = _spec_inputs(30)
    mod = j_audio.AudioCNN(output_size=64, encode_mono_n_mono_from_mem=mono_mode)
    if mono_mode:
        args, t_args = {"pred_mono_n_mono_from_mem": jnp.asarray(masks)}, {
            "pred_mono_n_mono_from_mem": torch.tensor(masks)}
    else:
        args = {"mixed_log_mag": jnp.asarray(mix), "pred_bin_sep_masks": jnp.asarray(masks)}
        t_args = {"mixed_log_mag": torch.tensor(mix), "pred_bin_sep_masks": torch.tensor(masks)}
    p, _ = _init(mod, 4, **args)
    out = mod.apply({"params": p}, **args)
    t = _load(AudioCNN(64, mono_mode), P.audio_cnn(p))
    with torch.no_grad():
        _close(t(**t_args), out)


@pytest.mark.parametrize("extra_depth", [False, True], ids=["rgbd", "rgb"])
def test_visual_cnn_matches_jax(extra_depth):
    rng = np.random.default_rng(40)
    rgb = rng.integers(0, 256, (B, 128, 128, 3)).astype(np.uint8)
    depth = rng.uniform(0, 1, (B, 128, 128, 1)).astype(np.float32)
    mod = j_visual.VisualCNN(output_size=64, extra_depth=extra_depth)
    p, _ = _init(mod, 5, jnp.asarray(rgb), jnp.asarray(depth))
    out = mod.apply({"params": p}, jnp.asarray(rgb), jnp.asarray(depth))
    t = _load(VisualCNN(64, extra_depth=extra_depth), P.visual_cnn(p))
    with torch.no_grad():
        _close(t(torch.tensor(rgb), torch.tensor(depth)), out)


def test_gru_single_step_with_masked_reset_matches_jax():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((3, 96)).astype(np.float32)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    m = np.array([[1.0], [0.0], [1.0]], np.float32)
    mod = j_rnn.GRUStateEncoder(hidden_size=32)
    p, _ = _init(mod, 6, jnp.asarray(x), jnp.asarray(h), jnp.asarray(m))
    out, new_h = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(h), jnp.asarray(m))
    t = _load(GRUStateEncoder(96, 32), P.gru(p))
    with torch.no_grad():
        t_out, t_h = t(torch.tensor(x), torch.tensor(h), torch.tensor(m))
    _close(t_out, out)
    _close(t_h, new_h)


def test_policy_act_matches_jax():
    """The separator chain and deterministic ``act`` of the full policy at
    hidden 32, through ``from_jax`` on the whole parameter tree."""
    hid = 32
    mix, _, tc = _spec_inputs(60)
    rng = np.random.default_rng(61)
    rgb = rng.integers(0, 256, (B, 128, 128, 3)).astype(np.uint8)
    depth = rng.uniform(0, 1, (B, 128, 128, 1)).astype(np.float32)
    hidden = rng.standard_normal((B, hid)).astype(np.float32)
    masks = np.array([[1.0], [0.0]], np.float32)
    prev = rng.standard_normal((B, 512, 32, 1)).astype(np.float32)
    obs = {"rgb": jnp.asarray(rgb), "depth": jnp.asarray(depth),
           "mixed_bin_audio_mag": jnp.asarray(mix), "target_class": jnp.asarray(tc)}
    pol = j_policy.Move2HearPolicy(num_actions=3, hidden_size=hid, extra_depth=True,
                                   use_ddppo=False)
    p, s = _init(pol, 7, obs, jnp.asarray(hidden), jnp.asarray(masks))
    v = _variables(p, s)
    M = j_policy.Move2HearPolicy
    pm = pol.apply(v, obs, method=M.get_binSepMasks)
    mono = pol.apply(v, pm, obs["mixed_bin_audio_mag"], method=M.convert_bin2mono)
    mem = pol.apply(v, mono, jnp.asarray(prev), method=M.get_monoFromMem)
    act = pol.apply(v, obs, jnp.asarray(hidden), jnp.asarray(masks), pm, mono, mem,
                    None, True, method=M.act)

    t = _load(Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=False), P.from_jax(p, s))
    t_obs = {"rgb": torch.tensor(rgb), "depth": torch.tensor(depth),
             "mixed_bin_audio_mag": torch.tensor(mix), "target_class": torch.tensor(tc)}
    with torch.no_grad():
        t_pm = t.get_binSepMasks(t_obs)
        t_mono = t.convert_bin2mono(t_pm, t_obs["mixed_bin_audio_mag"])
        t_mem = t.get_monoFromMem(t_mono, torch.tensor(prev))
        # the heads get the JAX separator outputs, so a 1e-3 drift in the
        # separators cannot flip an argmax and make the comparison moot
        t_act = t.act(t_obs, torch.tensor(hidden), torch.tensor(masks),
                      torch.tensor(np.asarray(pm)), torch.tensor(np.asarray(mono)),
                      torch.tensor(np.asarray(mem)), deterministic=True)
    _close(t_pm, pm, "binSep masks")
    _close(t_mono, mono, "bin2mono")
    _close(t_mem, mem, "acoustic mem")
    for name in ("value", "action_log_probs", "hidden", "probs"):
        _close(getattr(t_act, name), getattr(act, name), name)
    np.testing.assert_array_equal(t_act.action.numpy(), np.asarray(act.action))


def _oracle_sd(fx, mod):
    shapes = {k.split(f"shape/{mod}/", 1)[1]: tuple(fx[k])
              for k in fx.files if k.startswith(f"shape/{mod}/")}
    sd = synth_state_dict(shapes, int(fx[f"seed/{mod}"]))
    return {k: torch.as_tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("family", ["bin2mono_unet", "audio_bin", "mem_bn"])
def test_modules_match_reference_torch_outputs(family):
    """Reference weights load straight into the port's modules (same module
    names) and reproduce the reference's own torch outputs."""
    fx = np.load(FIX)
    with torch.no_grad():
        if family == "bin2mono_unet":
            enc = _load(PassiveSepEncoder(True), _oracle_sd(fx, "enc_mono"))
            bott, skips = enc(torch.tensor(fx["in/enc_mono/mix"]),
                              pred_bin_sep_masks=torch.tensor(fx["in/enc_mono/masks"]))
            _close(bott, fx["out/enc_mono/0"], "bottleneck")
            for i, s in enumerate(skips):
                _close(s, fx[f"out/enc_mono/{i + 1}"], f"skip {i}")
            dec = _load(PassiveSepDecoder(True), _oracle_sd(fx, "dec_mono"))
            refs = [torch.tensor(fx[f"out/enc_mono/{i}"]) for i in range(5)]
            _close(dec(refs[0], refs[1:]), fx["out/dec_mono/0"], "decoder")
        elif family == "audio_bin":
            net = _load(AudioCNN(512), _oracle_sd(fx, "audio_bin"))
            out = net(torch.tensor(fx["in/audio_bin/mix"]),
                      torch.tensor(fx["in/audio_bin/masks"]))
            _close(out, fx["out/audio_bin/0"])
        else:
            net = _load(AcousticMem(use_ddppo=False), _oracle_sd(fx, "mem_bn"))
            out = net(torch.tensor(fx["in/mem_bn/mono"]), torch.tensor(fx["in/mem_bn/prev"]))
            _close(out, fx["out/mem_bn/0"])

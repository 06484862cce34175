"""The port's bfloat16 compute (``TPU.COMPUTE_DTYPE`` bfloat16) against the
JAX package's flax ``dtype=jnp.bfloat16`` modules on the CPU. The same
flax parameters go to both packages (``utils/params.py:from_jax``); inputs
come from a numpy seed.

The discriminator: for every output tensor, the port's bfloat16 result must
be at least twice as close to the JAX bfloat16 result as the JAX bfloat16
result is to the JAX float32 one, in mean absolute error; and its largest
absolute error must stay within MAX_ULPS bfloat16 ulps of the tensor's
largest magnitude. A port that ignores the dtype sits as far from JAX
bfloat16 as JAX float32 does (ratio 1), and one that rounds in other places
(an fp32 bias add, autocast's cast caching) lands in between. The ratio is
on the mean, not the maximum: two correct bfloat16 convolutions that sum in
different orders round a few outputs to neighbouring bfloat16 values (one
ulp, where the dtype's own error is at most half of one), so a maximum
cannot tell them apart; the mean can.

JAX runs with full-precision float32 matmuls and without XLA's excess
precision (``xla_allow_excess_precision`` False), so each bfloat16 result
is rounded where flax's ``dtype=`` says; by default XLA:CPU drops
bfloat16 round trips between fused operations, a precision no flax module
asks for. The U-Nets and the passive policy run in test_torch_bf16_unets.py, the
policy's entry points in test_torch_bf16_policy.py, on this module's helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.models import audio_cnn as j_audio
from move2hear_tpu.models import distributions as j_dist
from move2hear_tpu.models import memory as j_memory
from move2hear_tpu.models import policy as j_policy
from move2hear_tpu.models import rnn as j_rnn
from move2hear_tpu.models import visual_cnn as j_visual
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu_torch.models import (
    AcousticMem,
    AudioCNN,
    CategoricalNet,
    CriticHead,
    GRUStateEncoder,
    Move2HearPolicy,
    VisualCNN,
)
from move2hear_tpu_torch.utils import params as P
from _torch_threads import cap_torch_threads

cap_torch_threads()

B = 4
HID = 32
BF16 = torch.bfloat16
RATIO = 2.0   # the port at least this much closer to JAX bf16 than JAX bf16 to f32
MAX_ULPS = 4  # the floor of the largest error, in bf16 ulps (2**-7 relative)


@pytest.fixture(autouse=True)
def _precise_matmuls_and_plain_route(monkeypatch):
    # an interpret-mode Pallas call elsewhere in the process would make the
    # JAX package's default route lower the Mosaic kernel on the CPU
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    with jax.default_matmul_precision("highest"):
        yield


def jit(fn):
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def discriminate(ours, j_bf16, j_f32, name: str) -> float:
    """Assert the discriminator on one output tensor (module docstring);
    returns the ratio of the mean errors."""
    ours, jb, jf = _np(ours), _np(j_bf16), _np(j_f32)
    assert ours.shape == jb.shape == jf.shape, (name, ours.shape, jb.shape)
    port_err = float(np.abs(ours - jb).mean())
    dtype_err = float(np.abs(jb - jf).mean())
    assert dtype_err > 0.0, f"{name}: JAX bfloat16 equals float32, nothing to discriminate"
    ratio = dtype_err / max(port_err, 1e-30)
    floor = MAX_ULPS * 2.0**-7 * float(np.abs(jf).max())
    worst = float(np.abs(ours - jb).max())
    assert ratio >= RATIO, (
        f"{name}: mean |port - jax_bf16| {port_err:.3e} is only {ratio:.2f}x below "
        f"mean |jax_bf16 - jax_f32| {dtype_err:.3e}")
    assert worst <= floor, f"{name}: max |port - jax_bf16| {worst:.3e} > {floor:.3e}"
    print(f"{name}: mean error ratio {ratio:.1f}, max |port - jax_bf16| {worst:.3e} "
          f"(floor {floor:.3e}, max |jax_bf16 - jax_f32| {float(np.abs(jb - jf).max()):.3e})")
    return ratio


def _np_tree(tree, rng):
    """flax variables -> numpy, with biases and BatchNorm statistics redrawn
    from `rng` so that every map carries non-trivial values."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _np_tree(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if k in ("mean", "bias"):
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


def _both(make, apply):
    """JAX (bfloat16, float32) results of ``apply(module)``, jitted alike."""
    return tuple(jit(lambda: apply(make(dt)))() for dt in (jnp.bfloat16, jnp.float32))


def _spec_inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((b, 512, 32, 2))).astype(np.float32)
    masks = rng.uniform(-0.2, 1.2, (b, 512, 32, 2)).astype(np.float32)
    tc = rng.integers(0, 10, (b, 1)).astype(np.int32)
    return mix, masks, tc


def _nchw(x):
    return torch.from_numpy(np.transpose(_np(x), (0, 3, 1, 2)).copy())


@pytest.mark.parametrize("use_ddppo", [True, False], ids=["ddppo", "batchnorm"])
def test_acoustic_mem_in_bfloat16(use_ddppo):
    rng = np.random.default_rng(20)
    mono = jnp.asarray(rng.standard_normal((B, 512, 32, 1)).astype(np.float32)).astype(jnp.bfloat16)
    prev = jnp.asarray(rng.standard_normal((B, 512, 32, 1)).astype(np.float32))
    p, s = _init(j_memory.AcousticMem(use_ddppo=use_ddppo), 3, mono, prev)
    jb, jf = _both(lambda dt: j_memory.AcousticMem(use_ddppo=use_ddppo, dtype=dt),
                   lambda m: m.apply(_variables(p, s), mono, prev))
    t = AcousticMem(use_ddppo, dtype=BF16)
    t.load_state_dict(P.acoustic_mem(p, s))
    with torch.no_grad():
        out = t.eval()(torch.from_numpy(_np(mono)).to(BF16), torch.from_numpy(_np(prev)))
    assert out.dtype == BF16
    discriminate(out, jb, jf, "acoustic memory")


@pytest.mark.parametrize("mono_mode", [False, True], ids=["bin", "monoNmonoFromMem"])
def test_audio_cnn_in_bfloat16(mono_mode):
    mix, masks, _ = _spec_inputs(30)
    jm = jnp.asarray(masks).astype(jnp.bfloat16)
    args = ({"pred_mono_n_mono_from_mem": jm} if mono_mode
            else {"mixed_log_mag": jnp.asarray(mix), "pred_bin_sep_masks": jm})
    p, _ = _init(j_audio.AudioCNN(output_size=64, encode_mono_n_mono_from_mem=mono_mode), 4,
                 **args)
    jb, jf = _both(lambda dt: j_audio.AudioCNN(64, mono_mode, dtype=dt),
                   lambda m: m.apply({"params": p}, **args))
    t = AudioCNN(64, mono_mode, dtype=BF16)
    t.load_state_dict(P.audio_cnn(p))
    tm = torch.from_numpy(masks).to(BF16)
    t_args = ({"pred_mono_n_mono_from_mem": tm} if mono_mode
              else {"mixed_log_mag": torch.from_numpy(mix), "pred_bin_sep_masks": tm})
    with torch.no_grad():
        out = t.eval()(**t_args)
    assert out.dtype == BF16
    discriminate(out, jb, jf, "audio cnn")


@pytest.mark.parametrize("extra_depth", [False, True], ids=["rgbd", "rgb"])
def test_visual_cnn_in_bfloat16(extra_depth):
    """Including the bfloat16 ``rgb / 255``."""
    rng = np.random.default_rng(40)
    rgb = rng.integers(0, 256, (B, 128, 128, 3)).astype(np.uint8)
    depth = rng.uniform(0, 1, (B, 128, 128, 1)).astype(np.float32)
    p, _ = _init(j_visual.VisualCNN(64, extra_depth=extra_depth), 5, jnp.asarray(rgb),
                 jnp.asarray(depth))
    jb, jf = _both(lambda dt: j_visual.VisualCNN(64, extra_depth=extra_depth, dtype=dt),
                   lambda m: m.apply({"params": p}, jnp.asarray(rgb), jnp.asarray(depth)))
    t = VisualCNN(64, extra_depth=extra_depth, dtype=BF16)
    t.load_state_dict(P.visual_cnn(p))
    with torch.no_grad():
        out = t.eval()(torch.from_numpy(rgb), torch.from_numpy(depth))
    assert out.dtype == BF16
    discriminate(out, jb, jf, "visual cnn")


@pytest.mark.parametrize("seq", [False, True], ids=["step", "sequence"])
def test_gru_in_bfloat16(seq):
    """bf16 gate GEMMs and gate math, the float32 carry promoting the new
    hidden state to float32; masked resets at a step and in a sequence."""
    rng = np.random.default_rng(50 + seq)
    t_len = 5
    x = rng.standard_normal((t_len, 3, 96) if seq else (3, 96)).astype(np.float32)
    h = rng.standard_normal((3, HID)).astype(np.float32)
    m = (rng.uniform(size=(t_len, 3, 1) if seq else (3, 1)) > 0.3).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    p, _ = _init(j_rnn.GRUStateEncoder(hidden_size=HID), 6, xb[0] if seq else xb,
                 jnp.asarray(h), jnp.asarray(m[0] if seq else m))
    (jb_out, jb_h), (jf_out, jf_h) = _both(
        lambda dt: j_rnn.GRUStateEncoder(HID, dtype=dt),
        lambda mod: mod.apply({"params": p}, xb, jnp.asarray(h), jnp.asarray(m)))
    assert jb_h.dtype == jnp.float32
    t = GRUStateEncoder(96, HID, dtype=BF16)
    t.load_state_dict(P.gru(p))
    with torch.no_grad():
        out, new_h = t(torch.from_numpy(_np(xb)).to(BF16), torch.from_numpy(h),
                       torch.from_numpy(m))
    assert out.dtype == new_h.dtype == torch.float32
    discriminate(out, jb_out, jf_out, "outputs")
    discriminate(new_h, jb_h, jf_h, "hidden")


def test_heads_in_bfloat16():
    """The action logits and the value come back as float32."""
    rng = np.random.default_rng(70)
    x = jnp.asarray(rng.standard_normal((8, HID)).astype(np.float32)).astype(jnp.bfloat16)
    for j_mod, t_mod, key in ((lambda dt: j_dist.CategoricalNet(3, dtype=dt),
                               lambda: CategoricalNet(HID, 3, dtype=BF16), "logits"),
                              (lambda dt: j_dist.CriticHead(dtype=dt),
                               lambda: CriticHead(HID, dtype=BF16), "value")):
        p, _ = _init(j_mod(jnp.float32), 8, x)
        jb, jf = _both(j_mod, lambda m: m.apply({"params": p}, x))
        if key == "logits":
            jb, jf = jb.logits, jf.logits
        t = t_mod()
        w = p["Dense_0"]
        t.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
            (next(iter(t.state_dict())), w["kernel"].T), (list(t.state_dict())[1], w["bias"]))})
        with torch.no_grad():
            out = t(torch.from_numpy(_np(x)).to(BF16))
        out = out.logits if key == "logits" else out
        assert out.dtype == torch.float32 and jb.dtype == jnp.float32
        discriminate(out, jb, jf, key)


def _policy_inputs(seed):
    mix, _, tc = _spec_inputs(seed)
    rng = np.random.default_rng(seed + 1)
    return {
        "rgb": rng.integers(0, 256, (B, 128, 128, 3)).astype(np.uint8),
        "depth": rng.uniform(0, 1, (B, 128, 128, 1)).astype(np.float32),
        "mixed_bin_audio_mag": mix, "target_class": tc,
        "hidden": rng.standard_normal((B, HID)).astype(np.float32),
        "masks": (rng.uniform(size=(B, 1)) > 0.3).astype(np.float32),
        "prev": rng.standard_normal((B, 512, 32, 1)).astype(np.float32),
    }


def _full_policy(seed, inp):
    obs = {k: jnp.asarray(inp[k]) for k in ("rgb", "depth", "mixed_bin_audio_mag",
                                              "target_class")}
    pol = j_policy.Move2HearPolicy(num_actions=3, hidden_size=HID, extra_depth=True)
    p, s = _init(pol, seed, obs, jnp.asarray(inp["hidden"]), jnp.asarray(inp["masks"]))
    t = Move2HearPolicy(3, HID, extra_depth=True, dtype=BF16)
    t.load_state_dict(P.from_jax(p, s))
    return obs, _variables(p, s), t.eval()

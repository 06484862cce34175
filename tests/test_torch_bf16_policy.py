"""The Move2Hear policy's act and evaluate_actions entry points in bfloat16
against the JAX package's flax policy on the CPU, under
tests/test_torch_bf16_models.py's discriminator (split from it)."""

import jax.numpy as jnp
import numpy as np
import torch

from move2hear_tpu.models import policy as j_policy
from test_torch_bf16_models import (
    BF16,
    HID,
    _full_policy,
    _np,
    _policy_inputs,
    _precise_matmuls_and_plain_route,
    discriminate,
    jit,
)
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_policy_act_in_bfloat16():
    """The separator chain and deterministic ``act`` of the full policy.
    Each stage takes the JAX bfloat16 chain's inputs (JAX float32 their
    float32 values), so the discriminator weighs each stage's own rounding,
    not the last ulp of the stage before it."""
    inp = _policy_inputs(60)
    obs, v, t = _full_policy(7, inp)
    M = j_policy.Move2HearPolicy

    def chain(dt, feed=None):
        pol = M(num_actions=3, hidden_size=HID, extra_depth=True, dtype=dt)

        def run():
            pm = pol.apply(v, obs, method=M.get_binSepMasks)
            pm_in = pm if feed is None else feed[0]
            mono = pol.apply(v, pm_in, obs["mixed_bin_audio_mag"], method=M.convert_bin2mono)
            mono_in = mono if feed is None else feed[1]
            mem = pol.apply(v, mono_in, jnp.asarray(inp["prev"]), method=M.get_monoFromMem)
            mem_in = mem if feed is None else feed[2]
            act = pol.apply(v, obs, jnp.asarray(inp["hidden"]), jnp.asarray(inp["masks"]),
                            pm_in, mono_in, mem_in, None, True, method=M.act)
            return pm, mono, mem, act
        return jit(run)()

    jb = chain(jnp.bfloat16)
    jf = chain(jnp.float32, feed=tuple(x.astype(jnp.float32) for x in jb[:3]))
    t_obs = {k: torch.from_numpy(inp[k]) for k in obs}
    pm_b, mono_b, mem_b = (torch.from_numpy(_np(x)).to(BF16) for x in jb[:3])
    with torch.no_grad():
        pm = t.get_binSepMasks(t_obs)
        mono = t.convert_bin2mono(pm_b, t_obs["mixed_bin_audio_mag"])
        mem = t.get_monoFromMem(mono_b, torch.from_numpy(inp["prev"]))
        act = t.act(t_obs, torch.from_numpy(inp["hidden"]), torch.from_numpy(inp["masks"]),
                    pm_b, mono_b, mem_b, deterministic=True)
    assert pm.dtype == mono.dtype == mem.dtype == BF16
    for i, (name, ours) in enumerate((("binSep masks", pm), ("bin2mono", mono),
                                      ("acoustic mem", mem))):
        discriminate(ours, jb[i], jf[i], name)
    for name in ("value", "hidden", "probs"):
        assert getattr(act, name).dtype == torch.float32
        discriminate(getattr(act, name), getattr(jb[3], name), getattr(jf[3], name), name)
    np.testing.assert_array_equal(act.action.numpy(), np.asarray(jb[3].action))


def test_policy_evaluate_actions_in_bfloat16():
    """The PPO update's sequence evaluation over (T, N) stored steps:
    bfloat16 stored separator outputs, float32 stored memory (as the
    rollout stores them)."""
    t_len, n = 3, 2
    inp = _policy_inputs(80)
    _, v, t = _full_policy(9, inp)
    rng = np.random.default_rng(81)
    seq = {
        "rgb": rng.integers(0, 256, (t_len, n, 128, 128, 3)).astype(np.uint8),
        "depth": rng.uniform(0, 1, (t_len, n, 128, 128, 1)).astype(np.float32),
        "mixed_bin_audio_mag": np.abs(rng.standard_normal((t_len, n, 512, 32, 2))).astype(
            np.float32),
        "target_class": rng.integers(0, 10, (t_len, n, 1)).astype(np.int32),
    }
    pm = rng.uniform(-0.2, 1.2, (t_len, n, 512, 32, 2)).astype(np.float32)
    mono = np.abs(rng.standard_normal((t_len, n, 512, 32, 1))).astype(np.float32)
    mem = rng.standard_normal((t_len, n, 512, 32, 1)).astype(np.float32)
    hidden = rng.standard_normal((n, HID)).astype(np.float32)
    masks = (rng.uniform(size=(t_len, n, 1)) > 0.3).astype(np.float32)
    action = rng.integers(0, 3, (t_len, n, 1)).astype(np.int32)
    pm_b = jnp.asarray(pm).astype(jnp.bfloat16)
    mono_b = jnp.asarray(mono).astype(jnp.bfloat16)
    M = j_policy.Move2HearPolicy

    def run(dt):
        pol = M(num_actions=3, hidden_size=HID, extra_depth=True, dtype=dt)
        return jit(lambda: pol.apply(
            v, {k: jnp.asarray(a) for k, a in seq.items()}, jnp.asarray(hidden),
            jnp.asarray(masks), jnp.asarray(action), pm_b, mono_b, jnp.asarray(mem),
            method=M.evaluate_actions))()

    jb, jf = run(jnp.bfloat16), run(jnp.float32)
    with torch.no_grad():
        out = t.evaluate_actions(
            {k: torch.from_numpy(a) for k, a in seq.items()}, torch.from_numpy(hidden),
            torch.from_numpy(masks), torch.from_numpy(action),
            torch.from_numpy(_np(pm_b)).to(BF16), torch.from_numpy(_np(mono_b)).to(BF16),
            torch.from_numpy(mem))
    for i, name in enumerate(("values", "log_probs", "entropy", "hidden")):
        assert out[i].dtype == torch.float32
        discriminate(out[i].reshape(-1), jnp.reshape(jb[i], (-1,)), jnp.reshape(jf[i], (-1,)),
                     name)

"""The host env path's separator refit, ``rl/ppo.py:make_update_sep``
(it renders the spectrograms anew from the stored keys), against the JAX
package's on one injected buffer on the CPU: hidden 32, 2 envs, 2 x 3
rows, RIR length 400, 2 epochs. Both packages take one render of the
buffer, JAX's, as tests/test_torch_pretrain.py does (two renders differ
by f16 ulps), and run in float64 (the JAX policy and its BatchNorm built
with a float64 dtype): losses within 1e-9 relative, and the change of
every parameter within 1e-6 of |change| + lr (the JAX change reaches the
port's layout through ``from_jax``, which rounds it to float32, 6e-8 of
the change). Then the host loop's render chunks (a rollout's rows at a
time) give the refit of one render of all rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.models import unet as j_unet
from move2hear_tpu.ops import frontend as jfrontend
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.ops.frontend import RenderedAudio
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID, N, T, S, R = 32, 2, 3, 2, 400
REL_F64 = 1e-9  # losses, float64 port against float64 JAX
REL_DELTA = 1e-6  # parameter changes, relative to |change| + lr


def _perturbed(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if k in ("mean", "bias"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "var":
            a = (0.5 + rng.uniform(0.0, 1.0, a.shape)).astype(np.float32)
        out[k] = a
    return out


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a).astype(np.float64) if np.asarray(a).dtype.kind == "f" else np.asarray(a)),
        tree)


@pytest.mark.parametrize("use_ddppo", [True, False])
def test_update_sep_matches_float64_jax(use_ddppo, monkeypatch):
    """One refit (2 epochs, lr scale 0.5) on an injected buffer of 2T rows:
    the frozen separators run on the render, then the acoustic memory trains
    on the L1 loss against the GT mono magnitude."""
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    rng = np.random.default_rng(4)
    rows = 2 * T
    buf = {
        "sound_ids": rng.integers(0, 12, (rows + 1, N, S)),
        "rirs": (0.05 * rng.standard_normal((rows + 1, N, S, R, 2))).astype(np.float32),
        "target_class": rng.integers(0, 10, (rows + 1, N, 1)),
        "prev_pred_monoFromMem": np.abs(rng.standard_normal((rows + 1, N, 512, 32, 1))).astype(np.float32),
        "masks": np.ones((rows + 1, N, 1), np.float32),
    }
    buf["masks"][T, 0] = 0.0
    bank = build_micro_scene(rows=2, cols=2, num_episodes=1, rir_length=R).audio_db.mono_bank()
    with jax.default_matmul_precision("highest"):
        j_policy = JPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=use_ddppo)
        obs = {"rgb": jnp.zeros((1, 128, 128, 3)), "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
               "target_class": jnp.zeros((1, 1), jnp.int32)}
        v = jax.jit(j_policy.init)(jax.random.PRNGKey(3), obs, jnp.zeros((1, HID)),
                                   jnp.ones((1, 1)))
        prng = np.random.default_rng(3)
        params, stats = _perturbed(v["params"], prng), _perturbed(v.get("batch_stats", {}), prng)
        flat = lambda a: a[:-1].reshape((rows * N,) + a.shape[2:])  # noqa: E731
        rendered = jax.jit(lambda w, r: jfrontend.render_binaural_mixture(
            w, r, gt_mono_mag_norm=1.2, mags_only=True))(bank[flat(buf["sound_ids"])], flat(buf["rirs"]))
        rendered = jax.tree.map(np.asarray, rendered)
        with jax.enable_x64(True):
            monkeypatch.setattr(jfrontend, "render_binaural_mixture",
                                lambda *a, **k: jfrontend.RenderedAudio(*map(jnp.float64, rendered)))
            bn = j_unet.nn.BatchNorm
            monkeypatch.setattr(j_unet.nn, "BatchNorm",
                                lambda *a, **k: bn(*a, **{**k, "dtype": jnp.float64}))
            j64 = JPolicy(num_actions=3, hidden_size=HID, extra_depth=True, use_ddppo=use_ddppo,
                          dtype=jnp.float64)
            jcfg = jppo.PPOConfig(ppo_epoch=2)
            p64, s64 = _f64(params), _f64(stats)
            j_state = jppo.create_agent_state(jcfg, {"params": p64, "batch_stats": s64})
            update = jppo.make_update_sep(j64, jcfg, N, gt_mono_mag_norm=1.2)
            j_state, j_losses = jax.jit(update)(j_state, _f64(buf), jnp.float64(bank),
                                       jax.random.PRNGKey(0), 0.5)
            # the change, mapped onto the port's layout (from_jax rounds it
            # to float32, 6e-8 of the change)
            j_delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), j_state.params, p64)
            j_losses = np.asarray(j_losses)

    monkeypatch.setattr(tppo, "render_binaural_mixture", lambda *a, **k: RenderedAudio(
        *(torch.from_numpy(np.array(x, np.float64)) for x in rendered)))
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=use_ddppo)
    policy.load_state_dict(from_jax(params, stats))
    policy.double()
    state = tppo.create_agent_state(tppo.PPOConfig(ppo_epoch=2), policy)
    buf64 = {k: torch.from_numpy(v.astype(np.float64) if v.dtype.kind == "f" else v)
             for k, v in buf.items()}
    losses = tppo.make_update_sep(policy, tppo.PPOConfig(ppo_epoch=2), N, gt_mono_mag_norm=1.2)(
        state, buf64, torch.from_numpy(bank.astype(np.float64)), None, 0.5)
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=REL_F64)
    delta = from_jax(j_delta, jax.tree.map(np.zeros_like, stats))
    before = {k: v.double() for k, v in from_jax(params, stats).items()}
    lr = tppo.PPOConfig().lr_sep
    moved = 0
    for k, p in policy.state_dict().items():
        if not p.is_floating_point():
            continue
        change = p - before[k]
        if k.split(".")[0] in tppo.SEP_TRAIN_KEYS and "running_" not in k:
            err = (change - delta[k].double()).abs() / (delta[k].double().abs() + lr)
            assert float(err.max()) <= REL_DELTA, (k, float(err.max()))
            moved += bool((change != 0).any())
        else:
            assert not change.any(), k  # the frozen groups and every statistic
    assert moved > 0


def test_update_sep_render_chunks_agree():
    """Rendering the buffer a rollout at a time (the host loop's chunk of T
    rows) gives the refit of one render of all rows."""
    rng = np.random.default_rng(5)
    rows = 2 * T
    buf = {
        "sound_ids": torch.from_numpy(rng.integers(0, 12, (rows + 1, N, S))),
        "rirs": torch.from_numpy((0.05 * rng.standard_normal((rows + 1, N, S, R, 2))).astype(np.float32)),
        "target_class": torch.from_numpy(rng.integers(0, 10, (rows + 1, N, 1))),
        "prev_pred_monoFromMem": torch.rand((rows + 1, N, 512, 32, 1)),
        "masks": torch.ones((rows + 1, N, 1)),
    }
    bank = torch.from_numpy(build_micro_scene(rows=2, cols=2, num_episodes=1).audio_db.mono_bank())
    out = []
    for chunk in (None, T):
        torch.manual_seed(0)
        policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
        state = tppo.create_agent_state(tppo.PPOConfig(ppo_epoch=1), policy)
        losses = tppo.make_update_sep(policy, tppo.PPOConfig(ppo_epoch=1), N, 1.2, chunk)(
            state, buf, bank)
        out.append((losses, policy.acoustic_mem.state_dict()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=0)
    for k, v in out[0][1].items():
        torch.testing.assert_close(v, out[1][1][k], rtol=1e-5, atol=1e-7)

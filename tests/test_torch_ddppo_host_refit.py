"""The host path's uncached separator refit with DDPPO's validity weights
against a float64 JAX reference on the CPU, at tests/test_torch_ddppo_refit.py's
tolerances (split from it)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.models import unet as j_unet
from move2hear_tpu.ops import frontend as jfrontend
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.ops.frontend import RenderedAudio
from move2hear_tpu_torch.rl import ppo as tppo
from move2hear_tpu_torch.utils.params import from_jax
from test_torch_train import _f64
from test_torch_ddppo_refit import N, _precise_matmuls_and_plain_route, _warm_torch_cpu_math
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_weighted_host_refit_matches_float64_jax(monkeypatch):
    """The host path's rendering refit with row weights: float64 on both
    sides on one render (JAX's), as tests/test_torch_host_refit.py."""
    hid, s, r, rows, fill = 32, 2, 400, 6, 4
    rng = np.random.default_rng(4)
    buf = {
        "sound_ids": rng.integers(0, 12, (rows + 1, N, s)),
        "rirs": (0.05 * rng.standard_normal((rows + 1, N, s, r, 2))).astype(np.float32),
        "target_class": rng.integers(0, 10, (rows + 1, N, 1)),
        "prev_pred_monoFromMem": np.abs(rng.standard_normal((rows + 1, N, 512, 32, 1))).astype(
            np.float32),
        "masks": np.ones((rows + 1, N, 1), np.float32),
    }
    buf["masks"][2, 0] = 0.0
    row_w = (np.arange(rows) < fill).astype(np.float64)
    bank = build_micro_scene(rows=2, cols=2, num_episodes=1, rir_length=r).audio_db.mono_bank()
    j_policy = JPolicy(num_actions=3, hidden_size=hid, extra_depth=True, use_ddppo=True)
    obs = {"rgb": jnp.zeros((1, 128, 128, 3)), "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
           "target_class": jnp.zeros((1, 1), jnp.int32)}
    v = jax.jit(j_policy.init)(jax.random.PRNGKey(3), obs, jnp.zeros((1, hid)), jnp.ones((1, 1)))
    params, stats = v["params"], v.get("batch_stats", {})
    flat = lambda a: a[:-1].reshape((rows * N,) + a.shape[2:])  # noqa: E731
    rendered = jax.tree.map(np.asarray, jax.jit(lambda w, q: jfrontend.render_binaural_mixture(
        w, q, gt_mono_mag_norm=1.2, mags_only=True))(bank[flat(buf["sound_ids"])],
                                                      flat(buf["rirs"])))
    with jax.enable_x64(True):
        monkeypatch.setattr(jfrontend, "render_binaural_mixture",
                            lambda *a, **k: jfrontend.RenderedAudio(*map(jnp.float64, rendered)))
        bn = j_unet.nn.BatchNorm
        monkeypatch.setattr(j_unet.nn, "BatchNorm",
                            lambda *a, **k: bn(*a, **{**k, "dtype": jnp.float64}))
        j64 = JPolicy(num_actions=3, hidden_size=hid, extra_depth=True, use_ddppo=True,
                      dtype=jnp.float64)
        jcfg = jppo.PPOConfig(ppo_epoch=2)
        p64 = _f64(params)
        j_state = jppo.create_agent_state(jcfg, {"params": p64, "batch_stats": _f64(stats)})
        update = jppo.make_update_sep(j64, jcfg, N, gt_mono_mag_norm=1.2, with_validity=True)
        j_state, j_losses = jax.jit(update)(j_state, _f64(buf), jnp.float64(bank),
                                            jax.random.PRNGKey(0), 0.5, jnp.asarray(row_w))
        j_delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), j_state.params, p64)
        j_losses = np.asarray(j_losses)

    monkeypatch.setattr(tppo, "render_binaural_mixture", lambda *a, **k: RenderedAudio(
        *(torch.from_numpy(np.array(x, np.float64)) for x in rendered)))
    policy = Move2HearPolicy(3, hid, extra_depth=True, use_ddppo=True)
    policy.load_state_dict(from_jax(params, stats))
    policy.double()
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    state = tppo.create_agent_state(tppo.PPOConfig(ppo_epoch=2), policy)
    buf64 = {k: torch.from_numpy(v.astype(np.float64) if v.dtype.kind == "f" else v)
             for k, v in buf.items()}
    update = tppo.make_update_sep(policy, tppo.PPOConfig(ppo_epoch=2), N, gt_mono_mag_norm=1.2,
                                  with_validity=True)
    losses = update(state, buf64, torch.from_numpy(bank.astype(np.float64)), None, 0.5,
                    row_weights=torch.from_numpy(row_w))
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=1e-9)
    delta = from_jax(j_delta, jax.tree.map(np.zeros_like, stats))
    lr, moved = tppo.PPOConfig().lr_sep, 0
    for k, p in policy.state_dict().items():
        if p.is_floating_point() and k.split(".")[0] in tppo.SEP_TRAIN_KEYS:
            change = p - before[k]
            err = (change - delta[k].double()).abs() / (delta[k].double().abs() + lr)
            assert float(err.max()) <= 1e-6, (k, float(err.max()))
            moved += bool((change != 0).any())
    assert moved > 0

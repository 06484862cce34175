"""Model parity against the REFERENCE's own torch forward passes.

``tests/fixtures/torch_oracle.npz`` holds, for every model family, the
state_dict shape manifest (weights regenerate deterministically via
torch_oracle_synth), the seeded inputs, and the outputs of the reference's
torch modules run in eval mode (generated by
scripts/gen_torch_oracle_fixtures.py against /root/reference). These tests
map the same weights onto our flax modules with
move2hear_tpu.utils.torch_import — the production checkpoint-import path —
and assert output parity. Unlike re-implemented numpy oracles, the expected
values here came from the reference code itself.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_threads import cap_torch_threads

cap_torch_threads()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from torch_oracle_synth import synth_state_dict  # noqa: E402

from move2hear_tpu.utils import torch_import as ti

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "torch_oracle.npz")


@pytest.fixture(scope="module")
def fx():
    data = np.load(FIX)
    return data


def _sd(fx, mod):
    shapes = {
        k.split(f"shape/{mod}/", 1)[1]: tuple(fx[k])
        for k in fx.files
        if k.startswith(f"shape/{mod}/")
    }
    return synth_state_dict(shapes, int(fx[f"seed/{mod}"]))


def _outs(fx, mod):
    idx = sorted(
        int(k.rsplit("/", 1)[1])
        for k in fx.files
        if k.startswith(f"out/{mod}/")
    )
    return [fx[f"out/{mod}/{i}"] for i in idx]


def _close(ours, ref, atol=2e-3, rtol=1e-3, msg=""):
    np.testing.assert_allclose(
        np.asarray(ours), ref, atol=atol, rtol=rtol, err_msg=msg
    )


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


@pytest.fixture(autouse=True)
def _precise_matmuls():
    # this image's XLA-CPU oneDNN matmuls default to low precision (~1e-2
    # error); the oracle comparison needs real f32
    with jax.default_matmul_precision("highest"):
        yield


def test_unet_encoders_and_decoders_match_torch(fx):
    from move2hear_tpu.models.unet import PassiveSepDecoder, PassiveSepEncoder

    mix = jnp.asarray(fx["in/enc_bin/mix"])
    tc = jnp.asarray(fx["in/enc_bin/tc"].astype(np.int32))
    masks = jnp.asarray(fx["in/enc_mono/masks"])

    for enc_name, dec_name, b2m, enc_args in (
        ("enc_bin", "dec_bin", False, {"target_class": tc}),
        ("enc_mono", "dec_mono", True, {"pred_bin_sep_masks": masks}),
    ):
        enc = PassiveSepEncoder(convert_bin2mono=b2m)
        ep, es = (
            ti.convert_unet_encoder(_sd(fx, enc_name), "")
        )
        x = masks if b2m else mix
        # bin2mono encoder input transform consumes (masks, mix)
        if b2m:
            bott, skips = enc.apply(
                {"params": ep, "batch_stats": es}, mix,
                pred_bin_sep_masks=masks,
            )
        else:
            bott, skips = enc.apply(
                {"params": ep, "batch_stats": es}, mix, **enc_args
            )
        ref = _outs(fx, enc_name)
        _close(bott, ref[0], msg=f"{enc_name} bottleneck")
        assert len(skips) == len(ref) - 1
        for i, (s, r) in enumerate(zip(skips, ref[1:])):
            _close(s, _nhwc(r), msg=f"{enc_name} skip {i}")

        dec = PassiveSepDecoder(convert_bin2mono=b2m)
        dp, ds = ti.convert_unet_decoder(_sd(fx, dec_name), "")
        out = dec.apply(
            {"params": dp, "batch_stats": ds},
            jnp.asarray(ref[0]),
            [jnp.asarray(_nhwc(r)) for r in ref[1:]],
        )
        _close(out, _outs(fx, dec_name)[0], msg=dec_name)


def test_acoustic_mem_matches_torch(fx):
    from move2hear_tpu.models.memory import AcousticMem

    mono = jnp.asarray(fx["in/mem_ddppo/mono"])
    prev = jnp.asarray(fx["in/mem_ddppo/prev"])
    for mod, use_ddppo in (("mem_ddppo", True), ("mem_bn", False)):
        params, stats = ti.convert_acoustic_mem(_sd(fx, mod), "", use_ddppo)
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        out = AcousticMem(use_ddppo=use_ddppo).apply(variables, mono, prev)
        _close(out, _outs(fx, mod)[0], msg=mod)


def test_policy_encoders_match_torch(fx):
    from move2hear_tpu.models.audio_cnn import AudioCNN
    from move2hear_tpu.models.visual_cnn import VisualCNN

    params = ti.convert_audio_cnn(_sd(fx, "audio_bin"), "")
    out = AudioCNN(output_size=512).apply(
        {"params": params},
        jnp.asarray(fx["in/audio_bin/mix"]),
        jnp.asarray(fx["in/audio_bin/masks"]),
    )
    _close(out, _outs(fx, "audio_bin")[0], msg="audio_bin")

    params = ti.convert_audio_cnn(_sd(fx, "audio_mem"), "")
    out = AudioCNN(output_size=512, encode_mono_n_mono_from_mem=True).apply(
        {"params": params},
        pred_mono_n_mono_from_mem=jnp.asarray(fx["in/audio_mem/cat"]),
    )
    _close(out, _outs(fx, "audio_mem")[0], msg="audio_mem")

    params = ti.convert_visual_cnn(_sd(fx, "visual"), "")
    out = VisualCNN(output_size=512).apply(
        {"params": params},
        jnp.asarray(fx["in/visual/rgb"]),
        jnp.asarray(fx["in/visual/depth"]),
    )
    _close(out, _outs(fx, "visual")[0], msg="visual")


def test_gru_matches_torch(fx):
    from move2hear_tpu.models.rnn import GRUStateEncoder

    params = ti.convert_gru(_sd(fx, "gru"), "")
    gru = GRUStateEncoder(hidden_size=512)
    h0 = jnp.asarray(fx["in/gru/h0"][0])  # (B, H)
    y_ref, h_ref, ys_ref, hs_ref = _outs(fx, "gru")

    y, h = gru.apply(
        {"params": params}, jnp.asarray(fx["in/gru/x1"]), h0,
        jnp.asarray(fx["in/gru/m1"]),
    )
    _close(y, y_ref, msg="gru single out")
    _close(h, h_ref[0], msg="gru single hidden")

    xs = fx["in/gru/xs"]
    ms = fx["in/gru/ms"]
    B = h0.shape[0]
    T = xs.shape[0] // B
    ys, hT = gru.apply(
        {"params": params},
        jnp.asarray(xs.reshape(T, B, -1)),
        h0,
        jnp.asarray(ms.reshape(T, B, 1)),
    )
    _close(np.asarray(ys).reshape(T * B, -1), ys_ref, msg="gru seq outs")
    _close(hT, hs_ref[0], msg="gru seq hidden")


def test_agent_state_dict_mapping_is_structurally_complete(fx):
    """convert_agent_state_dict maps a full reference ``agent.state_dict()``
    (synthesized from the per-module manifests with the real key prefixes)
    onto exactly the Move2HearPolicy variable tree — every leaf present,
    every shape right."""
    from move2hear_tpu.models import Move2HearPolicy

    agent_sd = {}
    prefix_of = {
        "visual": "actor_critic.pol_net.visual_encoder.",
        "audio_bin": "actor_critic.pol_net.bin_encoder.",
        "audio_mem": "actor_critic.pol_net.monoNmonoFromMem_encoder.",
        "gru": "actor_critic.pol_net.state_encoder.",
        "enc_bin": "actor_critic.binSep_enc.passive_sep_encoder.",
        "dec_bin": "actor_critic.binSep_dec.passive_sep_decoder.",
        "enc_mono": "actor_critic.bin2mono_enc.passive_sep_encoder.",
        "dec_mono": "actor_critic.bin2mono_dec.passive_sep_decoder.",
        "mem_ddppo": "actor_critic.acoustic_mem.",
    }
    for mod, prefix in prefix_of.items():
        for k, v in _sd(fx, mod).items():
            agent_sd[prefix + k] = v
    rng = np.random.default_rng(0)
    agent_sd["actor_critic.action_dist.linear.weight"] = (
        rng.standard_normal((4, 512)).astype(np.float32)
    )
    agent_sd["actor_critic.action_dist.linear.bias"] = np.zeros(4, np.float32)
    agent_sd["actor_critic.critic.fc.weight"] = (
        rng.standard_normal((1, 512)).astype(np.float32)
    )
    agent_sd["actor_critic.critic.fc.bias"] = np.zeros(1, np.float32)

    params, stats = ti.convert_agent_state_dict(agent_sd, use_ddppo=True)

    policy = Move2HearPolicy(num_actions=4, hidden_size=512, use_ddppo=True)
    n = 1
    obs = {
        "rgb": jnp.zeros((n, 128, 128, 3)),
        "depth": jnp.zeros((n, 128, 128, 1)),
        "mixed_bin_audio_mag": jnp.zeros((n, 512, 32, 2)),
        "target_class": jnp.zeros((n, 1), jnp.int32),
    }
    variables = policy.init(
        jax.random.PRNGKey(0), obs, jnp.zeros((n, 512)), jnp.ones((n, 1))
    )

    def tree_shapes(t):
        return jax.tree.map(lambda x: tuple(np.shape(x)), t)

    assert tree_shapes(params) == tree_shapes(variables["params"])
    assert tree_shapes(stats) == tree_shapes(variables["batch_stats"])


def test_import_torch_ckpt_cli_roundtrip(fx, tmp_path):
    """scripts/import_torch_ckpt.py converts a reference-layout .pth into a
    checkpoint our policy loads and runs."""
    torch = pytest.importorskip("torch")
    import importlib.util

    from move2hear_tpu.models import Move2HearPolicy
    from move2hear_tpu.utils.checkpoint import load_checkpoint

    prefix_of = {
        "visual": "actor_critic.pol_net.visual_encoder.",
        "audio_bin": "actor_critic.pol_net.bin_encoder.",
        "audio_mem": "actor_critic.pol_net.monoNmonoFromMem_encoder.",
        "gru": "actor_critic.pol_net.state_encoder.",
        "enc_bin": "actor_critic.binSep_enc.passive_sep_encoder.",
        "dec_bin": "actor_critic.binSep_dec.passive_sep_decoder.",
        "enc_mono": "actor_critic.bin2mono_enc.passive_sep_encoder.",
        "dec_mono": "actor_critic.bin2mono_dec.passive_sep_decoder.",
        "mem_ddppo": "actor_critic.acoustic_mem.",
    }
    sd = {}
    for mod, prefix in prefix_of.items():
        for k, v in _sd(fx, mod).items():
            sd[prefix + k] = torch.as_tensor(v)
    rng = np.random.default_rng(1)
    sd["actor_critic.action_dist.linear.weight"] = torch.as_tensor(
        rng.standard_normal((4, 512)).astype(np.float32)
    )
    sd["actor_critic.action_dist.linear.bias"] = torch.zeros(4)
    sd["actor_critic.critic.fc.weight"] = torch.as_tensor(
        rng.standard_normal((1, 512)).astype(np.float32)
    )
    sd["actor_critic.critic.fc.bias"] = torch.zeros(1)

    pth = str(tmp_path / "ckpt.0.pth")
    torch.save({"state_dict": sd, "config": {"note": "synthetic"}}, pth)

    script = os.path.join(
        os.path.dirname(os.path.dirname(__file__)),
        "scripts", "import_torch_ckpt.py",
    )
    spec = importlib.util.spec_from_file_location("import_torch_ckpt", script)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out_path = str(tmp_path / "imported.ckpt")
    import unittest.mock

    with unittest.mock.patch.object(
        sys, "argv", ["import_torch_ckpt.py", pth, out_path]
    ):
        cli.main()

    ckpt = load_checkpoint(out_path)
    policy = Move2HearPolicy(num_actions=4, hidden_size=512, use_ddppo=True)
    n = 1
    obs = {
        "rgb": jnp.asarray(
            np.random.default_rng(2).uniform(0, 255, (n, 128, 128, 3)),
            jnp.float32,
        ),
        "depth": jnp.zeros((n, 128, 128, 1)),
        "mixed_bin_audio_mag": jnp.asarray(
            np.random.default_rng(3).uniform(0, 1, (n, 512, 32, 2)),
            jnp.float32,
        ),
        "target_class": jnp.zeros((n, 1), jnp.int32),
    }
    variables = {
        "params": ckpt["params"], "batch_stats": ckpt["batch_stats"]
    }
    masks = policy.apply(
        variables, obs, method=Move2HearPolicy.get_binSepMasks
    )
    mono = policy.apply(
        variables, masks, obs["mixed_bin_audio_mag"],
        method=Move2HearPolicy.convert_bin2mono,
    )
    assert np.isfinite(np.asarray(masks)).all()
    assert np.isfinite(np.asarray(mono)).all()

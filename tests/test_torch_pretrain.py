"""The port's passive pretrain against the JAX package's on the CPU: the
synthetic data source, the passive policy's forward in both BatchNorm
modes, and one train step; then the CLI workflow (pretrain -> checkpoint
evaluation -> the RL trainer starting from the pretrained separators),
small, and the routes not ported, in test_torch_pretrain_cli.py. The loop
is in test_torch_pretrain_loop.py. The same flax parameters go to both
packages (``from_jax`` for the port); JAX runs with full-precision matmuls.

Tolerances: batches bitwise; the forward and the BatchNorm statistics it
updates 1e-5 relative (to the largest |value| of the tensor, as the
outputs cross zero); the train step against a float64 run of the JAX
package's own ``train_step``: in float64 element by element, in float32
per tensor in norm (see that test for why)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.models import unet as j_unet
from move2hear_tpu.models.policy import Move2HearPassiveWoMemoryPolicy as JPassive
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.ops.frontend import render_binaural_mixture as j_render
from move2hear_tpu.pretrain import trainer as j_trainer_mod
from move2hear_tpu.pretrain import PassiveTrainer as JTrainer
from move2hear_tpu.pretrain import SyntheticPassiveSource as JSource
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.models import Move2HearPassiveWoMemoryPolicy
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.pretrain import trainer as tpt
from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/pretrain_passive.yaml"
B = 4
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """In a process with JAX loaded, the first call of a torch transcendental
    over a large CPU tensor sometimes returns one intra-op thread's chunk off
    by up to 1.5e-4 relative (ROADMAP, Queue 3); later calls are exact. One
    call of each before the comparisons."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.atan2, torch.sqrt):
        fn(x, x) if fn is torch.atan2 else fn(x)


@pytest.fixture(autouse=True)
def _precise_matmuls_and_plain_route(monkeypatch):
    # an interpret-mode Pallas call elsewhere in the process would make the
    # JAX package's default route lower the Mosaic kernel on the CPU
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    with jax.default_matmul_precision("highest"):
        yield


def small_sources(cls):
    """Train 8, val 4, nonoverlapping val 4 datapoints, RIR length 500."""
    return {
        "train": cls(num_datapoints=8, rir_length=500, seed=0),
        "val": cls(num_datapoints=4, rir_length=500, seed=1),
        "nonoverlapping_val": cls(num_datapoints=4, rir_length=500, seed=2),
    }


def _perturbed(tree, rng):
    """Redraw biases and BatchNorm statistics so that the maps and the
    running-statistics update carry non-trivial values."""
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


def _flax_weights(seed=0):
    obs = {"mixed_bin_audio_mag": jnp.zeros((2, 512, 32, 2)),
           "target_class": jnp.zeros((2, 1), jnp.int32)}
    v = jax.jit(lambda k, o: JPassive().init(k, o, train=False))(jax.random.PRNGKey(seed), obs)
    rng = np.random.default_rng(seed)
    return _perturbed(v["params"], rng), _perturbed(v["batch_stats"], rng)


def _configs(tmp_path, *opts):
    opts = ["Pretrain.Passive.BATCH_SIZE", str(B), *opts]
    return (j_get_config(EXP, opts + ["TPU.MESH_SHAPE", "[1]"], str(tmp_path / "jax"), "train"),
            get_config(EXP, opts, str(tmp_path / "port"), "train"))


def _close(ours, ref, msg, rel=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(ours, np.float64), ref, rtol=rel,
                               atol=rel * np.abs(ref).max(), err_msg=msg)


def test_synthetic_source_batches_equal_the_jax_packages(tmp_path):
    """The trainers' default sources (256 / 64 / 64 datapoints, RIR length
    2000): random train batches from one generator, in order, and the
    deterministic validation batches, bitwise."""
    jcfg, cfg = _configs(tmp_path)
    ours = tpt.PassiveTrainer(cfg, device="cpu")._sources
    ref = JTrainer(jcfg)._sources
    assert {k: len(v) for k, v in ours.items()} == {k: len(v) for k, v in ref.items()} == {
        "train": 256, "val": 64, "nonoverlapping_val": 64}
    rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        a, b = ours["train"].sample_batch(rng_a, 5), ref["train"].sample_batch(rng_b, 5)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for split in ("val", "nonoverlapping_val"):
        a = ours[split].sample_batch(rng_a, 64, deterministic=True, start=0)
        b = ref[split].sample_batch(rng_b, 64, deterministic=True, start=0)
        for k in b:
            assert np.array_equal(a[k], b[k]), (split, k)
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)  # same draws consumed
    assert (ours["train"].sample_batch(rng_a, 64)["target_class"] != 11).all()  # never esc


@pytest.mark.parametrize("train", [True, False])
def test_passive_forward_matches_jax(train):
    """Both outputs, and in training mode the BatchNorm statistics: flax
    moves the running variance towards the biased batch variance, which
    nn.BatchNorm2d's own update (the unbiased one) would miss by far more
    than the tolerance (4/3 at the 1x1 bottleneck of a batch of 4)."""
    params, stats = _flax_weights(1)
    rng = np.random.default_rng(2)
    mix = np.abs(rng.standard_normal((B, 512, 32, 2))).astype(np.float32)
    tc = rng.integers(0, 11, (B, 1)).astype(np.int32)
    obs = {"mixed_bin_audio_mag": jnp.asarray(mix), "target_class": jnp.asarray(tc)}
    variables = {"params": params, "batch_stats": stats}
    if train:
        (j_masks, j_mono), mutated = jax.jit(lambda v, o: JPassive().apply(
            v, o, train=True, mutable=["batch_stats"]))(variables, obs)
        j_stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    else:
        j_masks, j_mono = jax.jit(lambda v, o: JPassive().apply(v, o, train=False))(variables, obs)
    policy = Move2HearPassiveWoMemoryPolicy()
    policy.load_state_dict(from_jax(params, stats))
    policy.train(train)
    with torch.no_grad():
        masks, mono = policy({"mixed_bin_audio_mag": torch.from_numpy(mix),
                              "target_class": torch.from_numpy(tc)})
    _close(masks, j_masks, "masks")
    _close(mono, j_mono, "mono")
    ours, before, after = policy.state_dict(), from_jax(params, stats), (
        from_jax(params, j_stats) if train else None)
    n = 0
    for k, v in ours.items():
        if "running" not in k:
            continue
        if not train:
            assert torch.equal(v, before[k]), k
            continue
        _close(v, after[k], k)
        n += 1
        if k.startswith("binSep_enc.cnn.4") and k.endswith("running_var"):
            # the unbiased update's batch term is n/(n-1) = 4/3 times larger
            # (flax: 0.9 * before + 0.1 * biased batch variance)
            unbiased = after[k] + (after[k] - 0.9 * before[k]) * (B / (B - 1) - 1.0)
            assert float((unbiased - after[k]).abs().max()) > 1e-3 * float(after[k].abs().max())
    assert n == (4 * 5 * 2 if train else 0)
    if train:
        assert all(int(v) == 1 for k, v in ours.items() if k.endswith("num_batches_tracked"))


def test_train_step_matches_float64_jax(tmp_path, monkeypatch):
    """One train step at B=4 and an eval step after it, from the same
    weights and batch: JAX's ``PassiveTrainer._build_steps()`` steps in
    float64 against the port's steps in float64 and in float32.

    The reference is float64 throughout: its U-Nets are built with a float64
    dtype, its BatchNorm (whose output the package casts to float32) computes
    in float64 here, and both packages take one render of the batch, JAX's,
    computed once. Two renders differ by f16 ulps at about one element in
    ten (the render's storage casts, ROADMAP Queue 3; the port's own render
    is held to JAX's at the render tolerance of tests/test_torch_kernels.py),
    even JAX's alone when fused into another program, and the L1 loss's
    gradient is a sign: a ground-truth bin that moves across the prediction
    flips one term, which moved gradients by up to 3% in norm.

    Gates: the float64 port's losses within 1e-12 relative and its change of
    every parameter and BatchNorm statistic within 1e-9 of |p| + lr of JAX's,
    element by element: so the biased running-variance update, the momentum
    and the optimizer are JAX's. The float32 port's losses within 1e-4
    relative and each BatchNorm statistic's change within 1e-4 in norm; each
    parameter tensor's change within 1e-2 in norm, which a wrong sign, a
    missing or a doubled gradient exceed a hundredfold. The float32
    parameters are not within 1e-4 of |p| + lr: training-mode BatchNorm
    cancels most of the gradient of the layers before it, so entries near
    Adam's eps (1e-5) carry float32 rounding into the step times lr / 1e-5
    (1.1e-3 of |p| + lr at the worst entry here, as far from the port's own
    float64 step; 1.3e-4 of a tensor's change in norm), and a ReLU, a
    LeakyReLU or an L1 term that float32 puts on the other side of its kink
    moves a gradient further (chip_smoke.py's pretrain-parity phase holds
    the card to a float64 run on the card's side of every kink). The masks reach the bin2mono encoder detached, so its loss
    gives the binaural pair no gradient (checked by a step on the mono loss
    alone), and no gradient reaches masked_mix_slice16."""
    params, stats = _flax_weights(3)
    jcfg, cfg = _configs(tmp_path)
    batch = small_sources(JSource)["train"].sample_batch(np.random.default_rng(0), B)
    with jax.enable_x64(True):
        jt = JTrainer(jcfg, sources=small_sources(JSource))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        rendered = jax.jit(lambda w, r: j_render(w, r, gt_mono_mag_norm=jt._gt_mono_mag_norm))(
            jb["mono_wavs"], jb["rirs"])
        monkeypatch.setattr(j_trainer_mod, "render_binaural_mixture", lambda *a, **k: rendered._replace(
            mixed_bin_audio_mag=rendered.mixed_bin_audio_mag.astype(jnp.float64)))
        bn = j_unet.nn.BatchNorm
        monkeypatch.setattr(j_unet.nn, "BatchNorm",
                            lambda *a, **k: bn(*a, **{**k, "dtype": jnp.float64}))
        jt.policy = JPassive(dtype=jnp.float64)
        tx, train_step, eval_step = jt._build_steps()
        p64, s64 = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t) for t in (params, stats))
        new_p, new_s, _, j_bin, j_mono = train_step(p64, s64, tx.init(p64), jb)
        j_eval = np.asarray(eval_step(new_p, new_s, jb))
        j_losses = np.array([float(j_bin), float(j_mono)])
        # the changes, mapped onto the port's layout: from_jax is a linear
        # map that rounds to float32, so it maps a float32 head and the
        # float32 rest separately
        diff = [jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), n, o)
                for n, o in ((new_p, p64), (new_s, s64))]
        head = [jax.tree.map(lambda d: d.astype(np.float32), t) for t in diff]
        rest = [jax.tree.map(lambda d, h: d - h, t, h) for t, h in zip(diff, head)]
        delta = {k: v.double() + r.double()
                 for (k, v), r in zip(from_jax(*head).items(), from_jax(*rest).values())}
    monkeypatch.undo()

    inputs = {
        "mixed_bin_audio_mag": torch.tensor(np.asarray(rendered.mixed_bin_audio_mag)),
        "target_class": torch.from_numpy(batch["target_class"]),
        "gt_bin_mag": torch.tensor(np.asarray(rendered.gt_bin_comps)[..., 0::2][..., :2]),
        "gt_mono_mag": torch.tensor(np.asarray(rendered.gt_mono_comps)[..., 0::2][..., :1]),
    }
    trainer = tpt.PassiveTrainer(cfg, sources=small_sources(SyntheticPassiveSource), device="cpu",
                                 weights=from_jax(params, stats))
    own = trainer.render(trainer.to_device(batch))
    for k, v in inputs.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=2e-3, atol=2e-4, err_msg=k)
    start = {k: v.double() for k, v in from_jax(params, stats).items()}
    lr = cfg.Pretrain.Passive.lr
    kernels.reset_launch_counts()
    # elem: element by element, relative to |p| + lr; None: per tensor in norm
    for dtype, loss_rel, elem in ((torch.float64, 1e-12, 1e-9), (torch.float32, REL, None)):
        policy = trainer.new_policy().to(dtype)
        losses = trainer.train_step(policy, trainer.new_optimizer(policy), inputs)
        np.testing.assert_allclose(losses.double().numpy(), j_losses, rtol=loss_rel)
        n = 0
        for k, v in policy.state_dict().items():
            if not v.is_floating_point():
                assert int(v) == 1, k  # num_batches_tracked
                continue
            dp, ref = v.double() - start[k], delta[k]
            assert ref.norm() > 0, k  # every parameter and statistic moved
            if elem is None:
                err = float((dp - ref).norm() / ref.norm())
                tol = REL if "running_" in k else 1e-2
            else:
                err = float(((dp - ref).abs() / (start[k].abs() + lr)).max())
                tol = elem
            assert err <= tol, (dtype, k, err)
            n += 1
        assert n == len(start) - 4 * 5  # all but num_batches_tracked
        np.testing.assert_allclose(trainer.eval_step(policy, inputs).double().numpy(), j_eval,
                                   rtol=loss_rel)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)  # CPU: plain

    # the mono loss alone moves only the bin2mono pair
    policy = trainer.new_policy()
    policy.train()
    trainer.losses(policy, inputs)[1].backward()
    for name, p in policy.named_parameters():
        moved = p.grad is not None and bool(p.grad.any())
        assert moved == name.startswith("bin2mono"), name

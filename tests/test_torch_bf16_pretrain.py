"""The passive pretrain in bfloat16 (``TPU.COMPUTE_DTYPE`` bfloat16) against
the JAX package's on the CPU: one train step from the same flax weights on
the same render (JAX's, computed once), then an eval step on the stepped
weights, at B = 4; and two bfloat16 epochs of the port's trainer with
finite losses (the mirror of tests/test_pretrain.py's bfloat16 test).
JAX's steps are compiled without XLA's excess precision
(tests/test_torch_bf16_models.py says why).

Tolerance: the losses within LOSS_REL relative. Training-mode BatchNorm at
a batch of 4 normalises by statistics of 4 samples (of 1x1 maps at the
bottleneck), which carries the two packages' bfloat16 rounding differences
(an ulp here and there) into every output; the losses average them."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.models.policy import Move2HearPassiveWoMemoryPolicy as JPassive
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.ops.frontend import render_binaural_mixture as j_render
from move2hear_tpu.pretrain import PassiveTrainer as JTrainer
from move2hear_tpu.pretrain import SyntheticPassiveSource as JSource
from move2hear_tpu.pretrain import trainer as j_trainer_mod
from move2hear_tpu_torch.pretrain import trainer as tpt
from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource
from move2hear_tpu_torch.utils.params import from_jax
from test_torch_pretrain import B, _configs, _flax_weights, small_sources
from _torch_threads import cap_torch_threads

cap_torch_threads()

LOSS_REL = 2e-3


@pytest.fixture(autouse=True)
def _plain_route(monkeypatch):
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})
    with jax.default_matmul_precision("highest"):
        yield


def test_bf16_train_and_eval_steps_match_jax(tmp_path, monkeypatch):
    params, stats = _flax_weights(3)
    jcfg, cfg = _configs(tmp_path, "TPU.COMPUTE_DTYPE", "bfloat16")
    batch = small_sources(JSource)["train"].sample_batch(np.random.default_rng(0), B)
    jt = JTrainer(jcfg, sources=small_sources(JSource))
    assert jt.policy.dtype == jnp.bfloat16
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rendered = jax.jit(lambda w, r: j_render(w, r, gt_mono_mag_norm=jt._gt_mono_mag_norm))(
        jb["mono_wavs"], jb["rirs"])
    monkeypatch.setattr(j_trainer_mod, "render_binaural_mixture", lambda *a, **k: rendered)
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda f, **k: jit(
        f, compiler_options={"xla_allow_excess_precision": False}, **k))
    tx, train_step, eval_step = jt._build_steps()
    monkeypatch.setattr(jax, "jit", jit)
    new_p, new_s, _, j_bin, j_mono = train_step(params, stats, tx.init(params), jb)
    j_eval = np.asarray(eval_step(new_p, new_s, jb))

    inputs = {
        "mixed_bin_audio_mag": torch.tensor(np.asarray(rendered.mixed_bin_audio_mag)),
        "target_class": torch.from_numpy(batch["target_class"]),
        "gt_bin_mag": torch.tensor(np.asarray(rendered.gt_bin_comps)[..., 0::2][..., :2]),
        "gt_mono_mag": torch.tensor(np.asarray(rendered.gt_mono_comps)[..., 0::2][..., :1]),
    }
    trainer = tpt.PassiveTrainer(cfg, sources=small_sources(SyntheticPassiveSource), device="cpu",
                                 weights=from_jax(params, stats))
    policy = trainer.new_policy()
    assert policy.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in policy.parameters())
    losses = trainer.train_step(policy, trainer.new_optimizer(policy), inputs)
    ev = trainer.eval_step(policy, inputs)
    print("train", losses.tolist(), [float(j_bin), float(j_mono)], "eval", ev.tolist(),
          j_eval.tolist())
    np.testing.assert_allclose(losses.numpy(), [float(j_bin), float(j_mono)], rtol=LOSS_REL)
    np.testing.assert_allclose(ev.numpy(), j_eval, rtol=LOSS_REL)
    # the BatchNorm statistics stay float32 and moved as JAX's did
    ours = policy.state_dict()
    for k, v in from_jax(new_p, new_s).items():
        if "running_mean" in k:
            assert ours[k].dtype == torch.float32
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=LOSS_REL,
                                       atol=LOSS_REL * float(v.abs().max()), err_msg=k)


def test_two_bf16_epochs_train_to_finite_losses(tmp_path):
    _, cfg = _configs(tmp_path, "TPU.COMPUTE_DTYPE", "bfloat16", "Pretrain.Passive.NUM_EPOCHS",
                      "2")
    trainer = tpt.PassiveTrainer(cfg, sources=small_sources(SyntheticPassiveSource),
                                 device="cpu")
    trainer.train()
    assert len(trainer.epoch_log) == 2
    for h in trainer._val_history:
        assert np.isfinite([*h["train"], *h["val"], *h["nonoverlapping_val"]]).all(), h
    assert trainer.final_policy.dtype == torch.bfloat16
    shutil.rmtree(tmp_path)  # the best checkpoints, 0.4 GB each

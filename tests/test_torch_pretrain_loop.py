"""The port's pretrain loop against the JAX package's on the CPU: two epochs
of ``PassiveTrainer.train()`` in both packages (BATCH_SIZE 4; train 8,
val 4 and nonoverlapping-val 4 datapoints, RIR length 500, so two train
steps and one batch of each validation split an epoch) from the same flax
init, which the test computes as JAX's ``train()`` does.

Tolerance of the per-epoch losses: 2e-3 relative. Each package renders its
own batches, and two renders differ by f16 ulps at about one element in ten
(ROADMAP Queue 3); the L1 loss's gradient is a sign, so a ground-truth bin
that moves across the prediction flips one term of it, and Adam turns a
gradient entry near its eps (1e-5) into a step of up to lr. So the two
packages' weights part by up to lr (5e-4) in some entries after the first
step; the losses, means over 131,072 and 65,536 terms, move far less: the
largest difference measured over both epochs and all splits is 3.7e-4."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.models.policy import Move2HearPassiveWoMemoryPolicy as JPassive
from move2hear_tpu.ops import pallas_kernels as jpk
from move2hear_tpu.pretrain import PassiveTrainer as JTrainer
from move2hear_tpu.pretrain import SyntheticPassiveSource as JSource
from move2hear_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.ops import kernels
from move2hear_tpu_torch.pretrain import trainer as tpt
from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/pretrain_passive.yaml"
B = 4
OPTS = ["Pretrain.Passive.BATCH_SIZE", str(B), "Pretrain.Passive.NUM_EPOCHS", "2"]


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_math():
    """In a process with JAX loaded, the first call of a torch transcendental
    over a large CPU tensor sometimes returns one intra-op thread's chunk off
    by up to 1.5e-4 relative (ROADMAP, Queue 3); later calls are exact. One
    call of each before the comparisons."""
    x = torch.linspace(0.0, 2.0, 1 << 20)
    for fn in (torch.exp, torch.expm1, torch.log1p, torch.log, torch.cos, torch.sin,
               torch.sqrt):
        fn(x)
    torch.atan2(x, x)


@pytest.fixture(autouse=True)
def _plain_route(monkeypatch):
    # an interpret-mode Pallas call elsewhere in the process would make the
    # JAX package's default route lower the Mosaic kernel on the CPU
    monkeypatch.setattr(jpk, "_PALLAS_STATUS", {})


def small_sources(cls):
    return {
        "train": cls(num_datapoints=8, rir_length=500, seed=0),
        "val": cls(num_datapoints=4, rir_length=500, seed=1),
        "nonoverlapping_val": cls(num_datapoints=4, rir_length=500, seed=2),
    }


def test_two_epochs_match_jax_from_the_same_init(tmp_path):
    jcfg = j_get_config(EXP, OPTS + ["TPU.MESH_SHAPE", "[1]"], str(tmp_path / "jax"), "train")
    cfg = get_config(EXP, OPTS, str(tmp_path / "port"), "train")
    jt = JTrainer(jcfg, sources=small_sources(JSource))
    jt.train()
    # the init of JAX's train(): a deterministic sample (its generator is not
    # consumed) for the target-class shape, PRNGKey(SEED)
    sample = small_sources(JSource)["train"].sample_batch(
        np.random.default_rng(jcfg.SEED), 2, deterministic=True)
    init_obs = {"mixed_bin_audio_mag": jnp.zeros((2, 512, 32, 2)),
                "target_class": jnp.asarray(sample["target_class"][:2])}
    v = JPassive().init(jax.random.PRNGKey(jcfg.SEED), init_obs, train=False)
    weights = from_jax(jax.tree.map(np.asarray, v["params"]),
                       jax.tree.map(np.asarray, v["batch_stats"]))

    kernels.reset_launch_counts()
    ours = tpt.PassiveTrainer(cfg, sources=small_sources(SyntheticPassiveSource), device="cpu",
                              weights=weights)
    ours.train()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    assert len(ours._val_history) == len(jt._val_history) == 2
    worst = 0.0
    for epoch, (a, b) in enumerate(zip(ours._val_history, jt._val_history)):
        assert set(a) == set(b) == {"train", "val", "nonoverlapping_val"}
        for split in b:
            np.testing.assert_allclose(a[split], b[split], rtol=2e-3,
                                       err_msg=f"epoch {epoch} {split}")
            worst = max(worst, float(np.max(np.abs(np.subtract(a[split], b[split]))
                                            / np.abs(b[split]))))
    for split, name in tpt.BEST_CKPT.items():
        j_epoch = j_load_checkpoint(os.path.join(jcfg.CHECKPOINT_FOLDER, name))["extra_state"]
        ckpt = load_checkpoint(os.path.join(cfg.CHECKPOINT_FOLDER, name))
        assert ckpt["extra_state"]["epoch"] == j_epoch["epoch"], split
        assert int(ckpt["optimizer"]["state"][0]["step"]) == 2 * (j_epoch["epoch"] + 1)
    assert worst > 0.0  # the two runs are separate computations
    shutil.rmtree(tmp_path)

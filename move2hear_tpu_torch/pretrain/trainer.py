"""Supervised passive-separator pretraining (the reference's
``audio_separation/pretrain/passive/passive_trainer.py``; the JAX package's
``pretrain/trainer.py``), registered as trainer "passive".

One train step renders the batch on the device
(``ops.frontend.render_binaural_mixture``), runs the four U-Nets in
training mode (BatchNorm on batch statistics, running statistics updated as
flax updates them), takes the loss L1(mask * expm1(mix), gt_bin_mag) +
L1(pred_mono, gt_mono_mag) (passive_trainer.py:269-286), and applies
optax's clip-by-global-norm -> Adam (``rl/ppo.py:ClippedAdam``). The
bin2mono encoder takes the masks detached, as JAX's ``stop_gradient``, so
the step launches masked_mix_slice16's forward once and its backward never.

The epoch loop draws the train batches from ``numpy.random.default_rng(
SEED)`` exactly where the JAX loop does; the validation batches seed their
own generators. So both packages see the same batches. Per-step losses stay
on the device and are fetched once an epoch; the best checkpoint on each
validation split's mono loss is written as ``best_ckpt_val.pth`` and
``best_ckpt_nonoverlapping_val.pth`` (state dict, optimizer state, epoch and
config, ``utils/checkpoint.py``), which ``RL.PPO.
pretrained_passive_separators_ckpt`` reads.

The data comes from the reference's on-disk datasets when
``SIMULATOR.AUDIO.*`` points at them (``_file_sources``), else from the
synthetic sources. ``TPU.COMPUTE_DTYPE`` bfloat16 runs the U-Nets in
bfloat16 compute (``models/unet.py``) in training and checkpoint
evaluation; parameters, Adam state, the losses and BatchNorm (its world
statistics included) stay float32.

In a world of ranks (``parallel/ddppo.py``, one device each; a
``TPU.MESH_SHAPE`` above one device is refused) every rank draws the same
global batch of BATCH_SIZE and takes its BATCH_SIZE / world rows: its loss
is its share of the global mean, the gradients and the BatchNorm batch
statistics are summed over the world (``models/unet.py:BatchNorm2d``), and
each validation batch is split and its losses summed alike, so R ranks
train what one rank does on the whole batch; rank 0 writes the checkpoints.
A preemption signal saves the interrupted state at the epoch's end (the
train state, the batch generator and the best validation losses), which
the next launch of the experiment resumes, and requeues the job.
"""

import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from move2hear_tpu_torch.models.policy import Move2HearPassiveWoMemoryPolicy
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture
from move2hear_tpu_torch.ops.spec import masked_mix
from move2hear_tpu_torch.parallel.ddppo import (
    EXIT,
    load_interrupted_state,
    requeue_job,
    save_interrupted_state,
)
from move2hear_tpu_torch.parallel.dist import (
    all_reduce_,
    broadcast_module,
    collective_any,
    world,
)
from move2hear_tpu_torch.pretrain.dataset import (
    FilePassiveSource,
    PassiveDataSource,
    SyntheticPassiveSource,
)
from move2hear_tpu_torch.rl.base_trainer import BaseRLTrainer
from move2hear_tpu_torch.rl.ppo import ClippedAdam
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from move2hear_tpu_torch.utils.misc import tpu_dtype
from move2hear_tpu_torch.utils.registry import registry
from move2hear_tpu_torch.utils.tb import TensorboardWriter

logger = logging.getLogger(__name__)

VAL_SPLITS = ("val", "nonoverlapping_val")
BEST_CKPT = {"val": "best_ckpt_val.pth", "nonoverlapping_val": "best_ckpt_nonoverlapping_val.pth"}
# the rendered targets of the (bin, mono) losses
LOSS_TARGETS = ("gt_bin_mag", "gt_mono_mag")


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target).mean()


def passive_split_dirs(audio_cfg) -> Dict[str, Tuple[str, str, int]]:
    """split -> (datapoints dir, audio dir, per-scene cap) of the reference's
    on-disk layout; the nonoverlapping_val split reads the val datapoints
    with the held-out (unheard) audio pool (datasets/dataset.py:40-52)."""
    root = os.path.join(audio_cfg.SOURCE_AGENT_LOCATION_DATAPOINTS_DIR,
                        audio_cfg.PASSIVE_DATASET_VERSION)
    return {
        "train": (os.path.join(root, "train"), audio_cfg.PASSIVE_TRAIN_AUDIO_DIR,
                  audio_cfg.NUM_PASSIVE_DATAPOINTS_PER_SCENE),
        "val": (os.path.join(root, "val"), audio_cfg.PASSIVE_TRAIN_AUDIO_DIR,
                audio_cfg.NUM_PASSIVE_DATAPOINTS_PER_SCENE_EVAL),
        "nonoverlapping_val": (os.path.join(root, "val"),
                               audio_cfg.PASSIVE_NONOVERLAPPING_VAL_AUDIO_DIR,
                               audio_cfg.NUM_PASSIVE_DATAPOINTS_PER_SCENE_EVAL),
    }


def has_file_backed_passive_data(audio_cfg) -> bool:
    """True where the reference's on-disk datasets are: every split's
    datapoints and audio directories exist and the datapoints directories
    hold scene pickles."""
    for dp_dir, audio_dir, _ in passive_split_dirs(audio_cfg).values():
        if not (os.path.isdir(dp_dir) and os.path.isdir(audio_dir)):
            return False
        if not any(f.endswith(".pkl") for f in os.listdir(dp_dir)):
            return False
    return True


@registry.register_trainer(name="passive")
class PassiveTrainer(BaseRLTrainer):
    """`weights`, a state dict of ``Move2HearPassiveWoMemoryPolicy``, gives
    the starting weights; without it they are drawn from a generator seeded
    by SEED."""

    def __init__(self, config, sources: Optional[Dict[str, PassiveDataSource]] = None,
                 device="cuda", weights: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PassiveTrainer: no CUDA device; pass --device cpu for the CPU")
        self.dtype = tpu_dtype(config.TPU, "COMPUTE_DTYPE")
        # the config reader takes keys it does not know, so the JAX
        # package's knobs that this trainer would ignore are refused here
        if any(int(d) > 1 for d in config.TPU.get("MESH_SHAPE", [1])):
            raise NotImplementedError(
                f"TPU.MESH_SHAPE={list(config.TPU.MESH_SHAPE)}: each rank of the port "
                "pretrains on one device; its data parallelism is one rank per device, "
                "launched as a world through WORLD_SIZE (torchrun)"
            )
        p = config.Pretrain.Passive
        self._lr, self._eps, self._max_grad_norm = p.lr, p.eps, p.max_grad_norm
        self._num_epochs = p.NUM_EPOCHS
        self._batch_size = p.BATCH_SIZE
        self._rank, self._ranks = world()
        if self._batch_size % self._ranks:
            raise ValueError(f"Pretrain.Passive.BATCH_SIZE {self._batch_size} is not divisible "
                             f"by the world's {self._ranks} ranks")
        self._gt_mono_mag_norm = config.TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM
        self._sources = sources or self._default_sources()
        self._steps_per_epoch = max(1, len(self._sources["train"]) // self._batch_size)
        self._weights = weights

    def _default_sources(self):
        """The file-backed sources when SIMULATOR.AUDIO.* points at the
        reference's datasets (passive_trainer.py:114-155), else the
        synthetic procedural sources."""
        audio_cfg = self.config.TASK_CONFIG.SIMULATOR.AUDIO
        if has_file_backed_passive_data(audio_cfg):
            return self._file_sources(audio_cfg)
        return {
            "train": SyntheticPassiveSource(num_datapoints=256, seed=0),
            "val": SyntheticPassiveSource(num_datapoints=64, seed=1),
            "nonoverlapping_val": SyntheticPassiveSource(num_datapoints=64, seed=2),
        }

    @staticmethod
    def _file_sources(audio_cfg) -> Dict[str, FilePassiveSource]:
        """One FilePassiveSource per split over every scene pickle of its
        datapoints directory (datasets/dataset.py:39-58)."""
        sources = {}
        for split, (dp_dir, audio_dir, cap) in passive_split_dirs(audio_cfg).items():
            scenes = sorted(f[:-4] for f in os.listdir(dp_dir) if f.endswith(".pkl"))
            sources[split] = FilePassiveSource(
                datapoints_dir=dp_dir, rir_dir=audio_cfg.RIR_DIR, audio_dir=audio_dir,
                scenes=scenes, max_datapoints_per_scene=cap,
            )
            logger.info("%s: %d file-backed datapoints over %d scenes from %s",
                        split.upper(), len(sources[split]), len(scenes), dp_dir)
        return sources

    def new_policy(self) -> Move2HearPassiveWoMemoryPolicy:
        if self._weights is None:
            generator = torch.Generator().manual_seed(int(self.config.SEED))
            policy = Move2HearPassiveWoMemoryPolicy(generator=generator, dtype=self.dtype)
        else:
            policy = Move2HearPassiveWoMemoryPolicy(dtype=self.dtype)
            policy.load_state_dict(self._weights)
        return policy.to(self.device)

    def new_optimizer(self, policy) -> ClippedAdam:
        return ClippedAdam(list(policy.parameters()), self._max_grad_norm, self._eps)

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a numpy batch on the trainer's device; to a
        card through pinned memory, so the copy does not wait for the
        queued steps."""
        if self._ranks > 1:
            b = len(next(iter(batch.values()))) // self._ranks
            batch = {k: v[self._rank * b: (self._rank + 1) * b] for k, v in batch.items()}
        if self.device.type == "cpu":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # --- the steps -------------------------------------------------------
    def render(self, batch) -> Dict[str, torch.Tensor]:
        """A batch's step inputs, rendered on its device: the mixture's log
        magnitude (B, F, T, 2), the target class, and the ground-truth
        binaural (B, F, T, 2) and mono (B, F, T, 1) magnitudes."""
        r = render_binaural_mixture(
            batch["mono_wavs"], batch["rirs"], gt_mono_mag_norm=self._gt_mono_mag_norm
        )
        return {
            "mixed_bin_audio_mag": r.mixed_bin_audio_mag,
            "target_class": batch["target_class"],
            "gt_bin_mag": r.gt_bin_comps[..., 0::2][..., :2],
            "gt_mono_mag": r.gt_mono_comps[..., 0::2][..., :1],
        }

    @staticmethod
    def losses(policy, inputs, loss: Optional[Dict[str, Callable]] = None) -> torch.Tensor:
        """(bin, mono) losses of rendered inputs: `loss` maps each target's
        name (LOSS_TARGETS) to the function of (prediction, target) that
        scores it, L1 for both by default. The mixture enters the U-Nets in
        the policy's parameter dtype (float32; float64 for a reference run,
        on the same float32 render)."""
        loss = loss or dict.fromkeys(LOSS_TARGETS, l1_loss)
        mix = inputs["mixed_bin_audio_mag"].to(next(policy.parameters()).dtype)
        pred_masks, pred_mono = policy(
            {"mixed_bin_audio_mag": mix, "target_class": inputs["target_class"]}
        )
        preds = dict(zip(LOSS_TARGETS, (masked_mix(mix, pred_masks), pred_mono)))
        return torch.stack([loss[k](preds[k], inputs[k]) for k in LOSS_TARGETS])

    def train_step(self, policy, opt: ClippedAdam, inputs, loss=None) -> torch.Tensor:
        """One optimizer step in training mode on rendered inputs; returns
        the detached (bin, mono) losses (of the world's batch)."""
        policy.train()
        opt.zero_grad()
        # this rank's share of the world's means (each rank holds as many rows)
        losses = self.losses(policy, inputs, loss) / self._ranks
        losses.sum().backward()
        return opt.step(self._lr, extra=losses.detach())

    @torch.no_grad()
    def eval_step(self, policy, inputs, loss=None) -> torch.Tensor:
        """(bin, mono) losses of rendered inputs on the running statistics
        (of the world's batch)."""
        policy.eval()
        return all_reduce_(self.losses(policy, inputs, loss) / self._ranks)

    def _val_losses(self, policy, split: str, rng) -> Tuple[float, float]:
        """Mean (bin, mono) losses over a validation split's deterministic
        batches (`rng` is not consumed by them)."""
        src = self._sources[split]
        pend = [
            self.eval_step(policy, self.render(self.to_device(src.sample_batch(
                rng, self._batch_size, deterministic=True, start=i * self._batch_size))))
            for i in range(max(1, len(src) // self._batch_size))
        ]
        vb, vm = torch.stack(pend).cpu().numpy().mean(axis=0)
        return float(vb), float(vm)

    # --- the loop --------------------------------------------------------
    def train(self) -> None:
        """NUM_EPOCHS epochs; per epoch ``self.epoch_log`` gets the wall
        seconds of its train steps and validation (the losses' fetch at their
        end waits for the device), its train samples (this rank's) and the
        seconds of its checkpoint writes, and ``self._val_history`` its
        losses."""
        cfg = self.config
        t_setup = time.perf_counter()
        rng = np.random.default_rng(cfg.SEED)
        policy = self.new_policy()
        opt = self.new_optimizer(policy)
        best = dict.fromkeys(VAL_SPLITS, np.inf)
        start_epoch = 0
        snap = load_interrupted_state(cfg.JOB_ID, self._interrupt_scope())
        if snap is not None and set(snap.get("state_dict", {})) != set(policy.state_dict()):
            logger.warning("ignoring interrupted state of another model")
            snap = None
        if collective_any(snap is not None) and collective_any(snap is None):
            raise RuntimeError("the interrupted state was read on some ranks only: "
                               "INTERRUPTED_STATE_DIR must be one every rank sees")
        if snap is not None:
            policy.load_state_dict(snap["state_dict"])
            opt.load_state_dict(snap["optimizer"])
            extra = snap["extra_state"]
            start_epoch = int(extra["epoch"]) + 1
            rng.bit_generator.state = json.loads(extra["rng"])
            best = dict(extra["best"])
            logger.info("resumed the interrupted pretrain at epoch %d", start_epoch)
        broadcast_module(policy)
        self._val_history, self.epoch_log = [], []
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        is_rank0 = self._rank == 0
        tb = TensorboardWriter(cfg.TENSORBOARD_DIR if is_rank0 else "", flush_secs=30)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - t_setup

        stop = False
        for epoch in range(start_epoch, self._num_epochs):
            t0 = time.perf_counter()
            step_losses = [
                self.train_step(policy, opt, self.render(self.to_device(
                    self._sources["train"].sample_batch(rng, self._batch_size))))
                for _ in range(self._steps_per_epoch)
            ]
            tr_bin, tr_mono = (float(v) for v in torch.stack(step_losses).cpu().numpy().mean(axis=0))
            val_losses = {split: self._val_losses(policy, split, rng) for split in VAL_SPLITS}
            self.epoch_log.append({
                "seconds": time.perf_counter() - t0,
                "train_samples": self._steps_per_epoch * self._batch_size // self._ranks})
            logger.info(
                "epoch %d: train bin %.4f mono %.4f | val mono %.4f | nonoverlap val mono "
                "%.4f | %.1fs", epoch, tr_bin, tr_mono, val_losses["val"][1],
                val_losses["nonoverlapping_val"][1], self.epoch_log[-1]["seconds"],
            )
            self._val_history.append({"train": (tr_bin, tr_mono), **val_losses})
            # per-split epoch scalars (passive_trainer.py:254-255)
            tb.add_scalar("bin_loss/train", tr_bin, epoch)
            tb.add_scalar("mono_loss/train", tr_mono, epoch)
            for split, (vb, vm) in val_losses.items():
                tb.add_scalar(f"bin_loss/{split}", vb, epoch)
                tb.add_scalar(f"mono_loss/{split}", vm, epoch)
            # best-on-val checkpointing (passive_trainer.py:259-266)
            t_save = time.perf_counter()
            for split in VAL_SPLITS:
                if val_losses[split][1] < best[split]:
                    best[split] = val_losses[split][1]
                    if is_rank0:
                        self._save(os.path.join(cfg.CHECKPOINT_FOLDER, BEST_CKPT[split]),
                                   policy, opt, epoch)
            self.epoch_log[-1]["save_seconds"] = time.perf_counter() - t_save
            # the ranks agree on EXIT: a signal may reach one rank only
            if collective_any(EXIT.is_set()):
                EXIT.set()
                if is_rank0:
                    save_interrupted_state({
                        "state_dict": policy.state_dict(), "optimizer": opt.state_dict(),
                        "extra_state": {"epoch": epoch, "best": best,
                                        "rng": json.dumps(rng.bit_generator.state)},
                        "config": cfg.to_dict(),
                    }, cfg.JOB_ID, scope=self._interrupt_scope())
                    logger.info("preempted after epoch %d: interrupted state saved", epoch)
                    requeue_job()
                stop = True
                break
        tb.close()
        self.final_policy = policy
        if not stop:
            self._clear_interrupted_state()

    def _save(self, path, policy, opt, epoch):
        save_checkpoint(path, {
            "state_dict": policy.state_dict(),
            "optimizer": opt.state_dict(),
            "extra_state": {"epoch": epoch},
            "config": self.config.to_dict(),
        })

    def eval(self, eval_interval: int = 1, prev_ckpt_ind: int = -1):
        """Evaluate a checkpoint file, or every ``best_ckpt*``/``ckpt.*``
        ``.pth`` file of a directory, on both validation splits; writes
        ``<checkpoint>.eval.json`` ({split: {bin_loss, mono_loss}}) beside
        each and keeps {path: results} in ``self.last_eval``."""
        path = self.config.EVAL_CKPT_PATH_DIR
        if os.path.isfile(path):
            ckpts = [path]
        else:
            ckpts = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.startswith(("best_ckpt", "ckpt.")) and f.endswith(".pth"))
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {path}")
        rng = np.random.default_rng(self.config.SEED)
        policy = Move2HearPassiveWoMemoryPolicy(dtype=self.dtype).to(self.device)
        self.last_eval = {}
        for ckpt_path in ckpts:
            policy.load_state_dict(load_checkpoint(ckpt_path)["state_dict"])
            results = {}
            for split in VAL_SPLITS:
                vb, vm = self._val_losses(policy, split, rng)
                results[split] = {"bin_loss": vb, "mono_loss": vm}
                logger.info("%s | %s: bin %.4f mono %.4f", os.path.basename(ckpt_path),
                            split, vb, vm)
            with open(ckpt_path + ".eval.json", "w") as f:
                json.dump(results, f, indent=2)
            self.last_eval[ckpt_path] = results
        return results

"""The PPO trainer (``audio_separation/rl/ppo/ppo_trainer.py``; the JAX
package's ``rl/trainer.py``): training on the device path or the host env
path, and checkpoint evaluation on the device or the host evaluator.

Cyclic schedule (ppo_trainer.py:730-994): num_updates_per_cycle x
(collect num_steps + policy update), then the separator refit over the
cycle's buffer. The gate of ``train``: the device path with the dense RIR
banks when they fit ``TPU.MAX_DEVICE_BANK_BYTES``, else with the
episode-keyed sub-bank slab (``env/sub_bank.py``) when that fits, else the
host env path (``_train_host``: host envs in worker processes, one device
step per env step); ``TPU.RIR_MODE`` dense, sub or host forces a route and
``TPU.DEVICE_ENV`` False forces the host path. The device path trains with
separation rewards (near-target, ``sep_reward_weight`` 1 and
``nav_reward_weight`` 0) or navigation rewards (far-target, 0 and 1); the
host path, as the JAX package's, with separation rewards at (1, 0) and the
env's rewards otherwise. Scene data comes from SoundSpaces-layout files
when the config points at them (``env/bundle.py``), else from the
synthetic micro-scene.

DDPPO: launched as a world of ranks (torchrun's or SLURM's variables,
``parallel/ddppo.py``), each rank trains NUM_PROCESSES envs on its device;
the world's envs split the episodes, draw their actions from one global
draw and reduce their updates over the world (``parallel/dist.py``), so R
ranks x N envs train as one rank of R*N envs. The preemptive rollout sync
(``use_ddppo``, a world above one rank and ``short_rollout_threshold`` < 1)
cuts rollouts once enough ranks are done; a preemption signal saves the
interrupted state, which the next launch of the experiment resumes.

``TPU.COMPUTE_DTYPE`` bfloat16 runs the policy in bfloat16 compute with
float32 parameters, Adam state and losses (``models/unet.py``);
``SEP_SLAB_DTYPE`` is the storage of the refit's slabs, ``SEP_REFIT_DTYPE``
the compute dtype of the refit alone, ``SUB_BANK_DTYPE`` the sub-bank
slab's storage. ``TPU.REPORT_MFU`` counts the FLOPs of the first cycle
(``trainer.mfu_info``).

``TPU.FUSED_CYCLE`` and ``TPU.PAIRWISE_FUSION`` make the JAX package run a
whole cycle, or each collect with its policy update, as one XLA program.
The port runs the same loops either way (a program split has no eager
counterpart) and takes over the routing the JAX package ties to them: the
rollouts store the frames rather than pose indices, the preemptive sync is
off, the gate never takes the sub-banks (auto falls back to the host path,
a forced ``RIR_MODE`` sub raises ValueError), ``REPORT_MFU`` is skipped with
the JAX package's warning, and under ``FUSED_CYCLE`` the lr and clip decay
is the fused cycle's float32 formula and the refit reads the collects'
outputs unrounded by ``SEP_SLAB_DTYPE``. ``TPU.COLLECT_UNROLL`` is the JAX
package's scan unroll of the collect; the port's collect is a Python loop
that every accepted value runs alike. The host path reads none of the
three, as the JAX package's. ``refuse_unported_knobs`` refuses the one
knob the port does not take (``MESH_SHAPE`` above one device).
"""

import dataclasses
import logging
import os
import time
from collections import deque
from typing import Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

import move2hear_tpu_torch.env.device_env as de
from move2hear_tpu_torch.env.bundle import (
    bundle_from_config,
    has_file_backed_data,
    split_scenes_round_robin,
)
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.env.sim import Action
from move2hear_tpu_torch.env.sub_bank import (
    RirSubBank,
    _count_unique_keys,
    estimate_sub_bank_bytes,
    fixed_bank_bytes,
    max_capacity_for_budget,
    row_bytes,
    sub_bank_capacity,
)
from move2hear_tpu_torch.env.vector_env import construct_envs
from move2hear_tpu_torch.eval.device_evaluator import evaluate_checkpoint_device
from move2hear_tpu_torch.eval.evaluator import evaluate_checkpoint, host_obs_to_device
from move2hear_tpu_torch.eval.metrics import stft_l2_distance
from move2hear_tpu_torch.models.policy import Move2HearPolicy
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture
from move2hear_tpu_torch.parallel.ddppo import (
    EXIT,
    RolloutSyncState,
    get_distrib_info,
    interrupted_state_path,
    load_interrupted_state,
    make_num_done_store,
    requeue_job,
    save_interrupted_state,
)
from move2hear_tpu_torch.parallel.dist import (
    COMM,
    broadcast_module,
    collective_any,
    gather_to_rank0,
    world,
    world_size,
)
from move2hear_tpu_torch.rl.base_trainer import BaseRLTrainer
from move2hear_tpu_torch.rl.device_rollout import (
    RolloutSepIdx,
    concat_collect_outputs,
    make_collect,
    make_update_sep_from_slabs,
    q_util,
    sep_reward,
    unpack_stats,
    write_sep_slab,
)
from move2hear_tpu_torch.rl.gae import compute_returns
from move2hear_tpu_torch.rl.ppo import (
    PPOConfig,
    create_agent_state,
    load_pretrained_passive_separators,
    make_update_pol,
    make_update_sep,
)
from move2hear_tpu_torch.rl.rollout import (
    after_update_pol,
    after_update_sep,
    create_rollout_pol,
    create_rollout_sep,
    insert_pol,
    insert_sep,
)
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from move2hear_tpu_torch.utils.misc import (
    DTYPE_KNOBS,
    linear_decay,
    linear_decay_float32,
    tpu_dtype,
)
from move2hear_tpu_torch.utils.registry import registry
from move2hear_tpu_torch.utils.tb import TensorboardWriter
from move2hear_tpu_torch.utils.torch_import import refuse_reference_layout

logger = logging.getLogger(__name__)


def refuse_unported_knobs(tpu, training: bool = True) -> None:
    """Refuse the JAX package's ``TPU`` knobs that the port would not
    honour, and knob values no route takes (ValueError). The port's default
    config lacks the unported knobs, but its reader takes keys it does not
    know, so without this they would run as if unset. Dtypes and the mesh
    apply to evaluation too; COLLECT_UNROLL only to training."""
    for key in DTYPE_KNOBS:
        tpu_dtype(tpu, key)
    if any(int(d) > 1 for d in tpu.get("MESH_SHAPE", [1])):
        raise NotImplementedError(
            f"TPU.MESH_SHAPE={list(tpu.MESH_SHAPE)}: each rank of the port runs on one "
            "device; its data parallelism is one rank per device, launched as a world "
            "through WORLD_SIZE (torchrun) with RL.PPO.ddppo_distrib_backend"
        )
    if not training:
        return
    # the JAX package hands int(COLLECT_UNROLL) to lax.scan, which takes 0
    # and any positive count and raises ValueError for a negative one
    if int(tpu.get("COLLECT_UNROLL", 1)) < 0:
        raise ValueError(f"TPU.COLLECT_UNROLL={tpu.COLLECT_UNROLL}: the collect's unroll must "
                         "be 0 or more")


def fusion_knob(tpu) -> bool:
    """TPU.FUSED_CYCLE or TPU.PAIRWISE_FUSION: the JAX package's fused
    routes, whose routing rules the port's device path follows."""
    return bool(tpu.get("FUSED_CYCLE", False)) or bool(tpu.get("PAIRWISE_FUSION", False))


MFU_METHOD = (
    "torch.utils.flop_counter.FlopCounterMode over the first training cycle (its "
    "collects, policy updates and refit): convolutions, transposed convolutions and "
    "matrix products, forward and backward, 2 FLOPs a multiply-add; no elementwise "
    "operation and no FFT (the JAX package's XLA cost_analysis counts both, and its "
    "render's DFT matmuls), and not cuDNN's float32 GRU (bfloat16 runs the GRU as "
    "matrix products, which are counted)"
)


def mfu_report(flops: Dict[str, float], cycle: int, env_steps: int) -> Dict:
    """``trainer.mfu_info`` (the JAX package's keys) from the FLOPs that
    REPORT_MFU counted over one cycle of `cycle` collects and policy
    updates and one refit, `env_steps` env-steps in all."""
    total = flops["collect"] + flops["update"] + flops["refit"]
    info = {
        "flops_per_rollout_collect": flops["collect"] / cycle,
        "flops_per_update_pol": flops["update"] / cycle,
        "flops_per_cycle_sep_refit": float(flops["refit"]),
        "flops_per_cycle_total": float(total),
        "env_steps_per_cycle": env_steps,
        "flops_per_env_step": total / env_steps,
        "method": MFU_METHOD,
    }
    logger.info("MFU count: %.3f GFLOPs/env-step (collect %.1f + pol %.1f + refit %.1f "
                "GF/cycle)", info["flops_per_env_step"] / 1e9, flops["collect"] / 1e9,
                flops["update"] / 1e9, flops["refit"] / 1e9)
    return info


@registry.register_trainer(name="ppo")
class PPOTrainer(BaseRLTrainer):
    def __init__(self, config, bundle=None, device="cuda"):
        super().__init__(config)
        self._bundle = bundle
        self.device = device
        self.last_eval = None  # (aggregates, timings) of the last checkpoint

    # ------------------------------------------------------------------
    def _ppo_config(self) -> PPOConfig:
        p = self.config.RL.PPO
        return PPOConfig(
            clip_param=p.clip_param, ppo_epoch=p.ppo_epoch, num_mini_batch=p.num_mini_batch,
            value_loss_coef=p.value_loss_coef, entropy_coef=p.entropy_coef,
            lr_pol=p.lr_pol, lr_sep=p.lr_sep, eps=p.eps, max_grad_norm=p.max_grad_norm,
            use_gae=p.use_gae, gamma=p.gamma, tau=p.tau,
        )

    def _make_bundle(self):
        if self._bundle is not None:
            return self._bundle
        cfg = self.config
        if has_file_backed_data(cfg.TASK_CONFIG):
            # EPS_SCENES restricts the train scene set (env_utils.py:552-553);
            # the evaluators filter their own episodes
            scenes = (list(cfg.EPS_SCENES)
                      if cfg.EPS_SCENES and cfg.TASK_CONFIG.DATASET.SPLIT[:5] == "train"
                      else None)
            self._bundle = bundle_from_config(cfg.TASK_CONFIG, scenes=scenes,
                                              max_rir_length=cfg.TPU.MAX_RIR_LENGTH)
            return self._bundle
        logger.warning("no scene bundle provided; using synthetic micro-scene")
        self._bundle = build_micro_scene(
            rows=4, cols=4, num_episodes=64, near_target=cfg.RL.PPO.sep_reward_weight == 1.0,
            rir_length=cfg.TPU.MAX_RIR_LENGTH,
        )
        return self._bundle

    def _new_policy(self) -> Move2HearPolicy:
        """The policy in TPU.COMPUTE_DTYPE with weights drawn from a
        generator seeded by cfg.SEED, on the trainer's device."""
        cfg, p = self.config, self.config.RL.PPO
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.SEED))
            policy = Move2HearPolicy(
                num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS),
                hidden_size=p.hidden_size, extra_rgb=cfg.EXTRA_RGB,
                extra_depth=cfg.EXTRA_DEPTH, use_ddppo=p.use_ddppo,
                dtype=tpu_dtype(cfg.TPU, "COMPUTE_DTYPE"),
            )
        return policy.to(self.device)

    # ------------------------------------------------------------------
    def train(self) -> None:
        """Dispatch to the device path, on the dense banks or the RIR
        sub-banks, or to the host env path. RIR_MODE dense, sub or host
        forces that route, and DEVICE_ENV False the host path; auto takes
        dense when its banks fit TPU.MAX_DEVICE_BANK_BYTES, else sub when the
        sub-bank at one window's capacity fits it and no fusion knob is set
        (``fusion_knob``), else host."""
        cfg = self.config
        forced = str(cfg.TPU.RIR_MODE)
        refuse_unported_knobs(cfg.TPU)
        if forced not in ("auto", "dense", "sub", "host"):
            raise ValueError(f"TPU.RIR_MODE must be auto|dense|sub|host, got {forced!r}")
        if forced == "host" or not cfg.TPU.DEVICE_ENV:
            self._train_host()
            return
        bundle = self._make_bundle()
        budget = int(cfg.TPU.MAX_DEVICE_BANK_BYTES)
        p = cfg.RL.PPO
        route = forced
        if route == "auto":
            dense = de.estimate_bank_bytes(bundle)
            # the dense RIR bank grows with V^2 per scene; the sub-bank, V-linearly
            sub = estimate_sub_bank_bytes(
                bundle, cfg.NUM_PROCESSES, cfg.NUM_SOUNDS_IN_MIX, p.num_steps,
                cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS,
                dtype_bytes=self._sub_dtype().itemsize,
            )
            route = ("dense" if dense <= budget
                     else "sub" if sub <= budget and not fusion_knob(cfg.TPU) else "host")
            if route != "dense":
                logger.warning(
                    "the device banks would take %.2f GiB dense and %.2f GiB sub-banked, "
                    "TPU.MAX_DEVICE_BANK_BYTES is %.2f GiB: using the %s", dense / 2**30,
                    sub / 2**30, budget / 2**30,
                    "episode-keyed RIR sub-banks" if route == "sub" else "host env path",
                )
        if route == "host":
            self._train_host()
            return
        # an explicit dense or sub skips the budget: a bank too large for the
        # device fails loudly when it is allocated
        if (p.sep_reward_weight, p.nav_reward_weight) not in ((1.0, 0.0), (0.0, 1.0)):
            raise NotImplementedError(
                f"sep_reward_weight {p.sep_reward_weight} with nav_reward_weight "
                f"{p.nav_reward_weight}: the device path trains with separation rewards "
                "(1, 0) or navigation rewards (0, 1), as the JAX package's does; it "
                "has no route that weighs the two (the host env path, TPU.RIR_MODE "
                "host, takes the env's rewards there)"
            )
        self._train_device(rir_mode=route)

    def _sub_dtype(self) -> torch.dtype:
        return tpu_dtype(self.config.TPU, "SUB_BANK_DTYPE")

    def sub_bank_rows(self, bundle, v_pad: int) -> int:
        """The sub route's slab rows: TPU.SUB_BANK_ROWS, or with 0, one
        window's need grown into the budget the fixed banks leave (each
        resident row saves a later re-upload) at TPU.SUB_BANK_DTYPE's bytes
        a sample, at most one a (scene, source) key."""
        cfg = self.config
        rows = int(cfg.TPU.SUB_BANK_ROWS)
        if rows:
            return rows
        n_keys = _count_unique_keys(bundle)
        min_cap = sub_bank_capacity(cfg.NUM_PROCESSES, int(cfg.NUM_SOUNDS_IN_MIX),
                                    cfg.RL.PPO.num_steps,
                                    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS, n_keys)
        spare = int(cfg.TPU.MAX_DEVICE_BANK_BYTES) - fixed_bank_bytes(bundle)
        return max_capacity_for_budget(
            spare, row_bytes(v_pad, bundle.audio_db.rir_length, self._sub_dtype().itemsize),
            min_cap, n_keys)

    def _make_sub_bank(self, bundle, dev, order, device) -> RirSubBank:
        """The RIR sub-bank of the sub route, ``sub_bank_rows`` slots of
        TPU.SUB_BANK_DTYPE."""
        cfg, p = self.config, self.config.RL.PPO
        dtype = self._sub_dtype()
        max_ep_steps = cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS
        v_pad = int(dev.scene.positions.shape[1])
        rows = self.sub_bank_rows(bundle, v_pad)
        sub_bank = RirSubBank(
            bundle.scenes, bundle.audio_db, dev.episodes.scene_idx.cpu().numpy(),
            dev.episodes.sources.cpu().numpy(), order, max_ep_steps, p.num_steps,
            v_pad=v_pad, capacity=rows, device=device, dtype=dtype,
        )
        logger.info("RIR sub-bank: %d rows x (4, %d, %d, 2) %s = %.2f GiB slab",
                    sub_bank.capacity, v_pad, bundle.audio_db.rir_length,
                    str(dtype).replace("torch.", ""),
                    sub_bank.capacity * sub_bank.row_bytes / 2**30)
        return sub_bank

    def _load_start_state(self, policy, state):
        """The start state: RESUME_CKPT's full train state, else this
        experiment's interrupted state (a file the port cannot read, or one
        of another model, is ignored with a warning), else the pretrained
        passive separators. In a world every rank loads the same and rank 0
        broadcasts the weights. Returns (update count, the interrupted
        snapshot or None)."""
        cfg, p = self.config, self.config.RL.PPO
        resume_path = cfg.RESUME_CKPT
        if resume_path:
            ckpt = load_checkpoint(resume_path)
            refuse_reference_layout(ckpt["state_dict"], f"RESUME_CKPT {resume_path}")
            policy.load_state_dict(ckpt["state_dict"])
            state.opt_pol.load_state_dict(ckpt["optimizer_pol"])
            state.opt_sep.load_state_dict(ckpt["optimizer_sep"])
            update_count = int(ckpt["extra_state"]["update_count"])
            logger.info("resumed full train state from %s at update %d", resume_path, update_count)
            broadcast_module(policy)
            return update_count, None
        snap = load_interrupted_state(cfg.JOB_ID, self._interrupt_scope())
        own = policy.state_dict()
        if snap is not None and (
            set(snap.get("state_dict", {})) != set(own)
            or any(tuple(v.shape) != tuple(own[k].shape) for k, v in snap["state_dict"].items())
        ):
            logger.warning("ignoring interrupted state %s: its parameters do not match this "
                           "config", interrupted_state_path(cfg.JOB_ID, self._interrupt_scope()))
            snap = None
        if collective_any(snap is not None) and collective_any(snap is None):
            raise RuntimeError("the interrupted state was read on some ranks only: "
                               "INTERRUPTED_STATE_DIR must be one every rank sees")
        if snap is not None:
            policy.load_state_dict(snap["state_dict"])
            state.opt_pol.load_state_dict(snap["optimizer_pol"])
            state.opt_sep.load_state_dict(snap["optimizer_sep"])
            update_count = int(snap["extra_state"]["update_count"])
            logger.info("resumed the interrupted train state at update %d", update_count)
            broadcast_module(policy)
            return update_count, snap
        if p.pretrained_passive_separators_ckpt:
            load_pretrained_passive_separators(
                policy, load_checkpoint(p.pretrained_passive_separators_ckpt)["state_dict"]
            )
            logger.info("loaded pretrained passive separators")
        broadcast_module(policy)
        return 0, None

    def _world(self):
        """(rank, ranks, envs of this rank, envs of the world) of the DDPPO
        world that sets the episode split, the sampled rows and the
        preemptive sync: the launch's (``get_distrib_info``), which must be
        the process group's when there is one."""
        _, rank, ranks = get_distrib_info()
        if world_size() > 1 and world() != (rank, ranks):
            raise RuntimeError(f"rank {rank} of {ranks} from the environment, but {world()} in "
                               "the process group")
        n = self.config.NUM_PROCESSES
        return rank, ranks, n, n * ranks

    def _make_rollout_sync(self, t_steps) -> RolloutSyncState:
        """The preemptive rollout sync (ppo_trainer.py:769-782) with its
        num-done store; tests replace it to inject a store."""
        p = self.config.RL.PPO
        rank, ranks, _, _ = self._world()
        return RolloutSyncState(
            sync_frac=p.sync_frac, short_rollout_threshold=p.short_rollout_threshold,
            num_steps=t_steps, world_size=ranks,
            store=make_num_done_store(rank, ranks, p.master_addr, p.master_port),
        )

    def _sync_possible(self) -> bool:
        p = self.config.RL.PPO
        return bool(p.use_ddppo) and self._world()[1] > 1 and p.short_rollout_threshold < 1.0

    def _check_preemption(self, state, update_count, generator, carry=None) -> bool:
        """At a cycle's end: the ranks agree on EXIT (a signal may reach one
        rank only), and on it rank 0 saves the interrupted state (the train
        state, the generator and, on the device path, the world's env
        carry, gathered) and requeues (ddppo_utils.py:26-110). True when the
        run is to stop."""
        if not collective_any(EXIT.is_set()):
            return False
        EXIT.set()
        gathered = None if carry is None else {k: gather_to_rank0(v) for k, v in carry.items()}
        if world()[0] == 0:
            path = save_interrupted_state({
                "state_dict": state.policy.state_dict(),
                "optimizer_pol": state.opt_pol.state_dict(),
                "optimizer_sep": state.opt_sep.state_dict(),
                "extra_state": {"update_count": update_count,
                                "generator": generator.get_state()},
                "carry": None if gathered is None else {k: v.cpu() for k, v in gathered.items()},
                "config": self.config.to_dict(),
            }, self.config.JOB_ID, scope=self._interrupt_scope())
            logger.info("preempted at update %d: interrupted state saved to %s", update_count,
                        path)
            requeue_job()
        return True

    def _train_device(self, rir_mode: str = "dense") -> None:
        """The device training loop on the separate-programs route: per
        cycle, `num_updates_per_cycle` x (collect + policy update), then the
        cached separator refit. Per cycle it records, in
        ``self.cycle_log``, the seconds of each phase, this rank's env-steps
        and the mean |reward| of its steps. The phases are timed by marks
        on the device's timeline (CUDA events, read at the stats fetch, so
        the loop never waits for the device only to time it; the host clock
        on the CPU, which finishes each op before it returns).

        rir_mode "sub" replaces the dense RIR bank by the episode-keyed
        slab (env/sub_bank.py), refreshed before each collect and
        prefetched after each policy update (TPU.SUB_PREFETCH); its
        counters go per cycle into ``self.sub_bank_log``.

        In a DDPPO world each rank runs NUM_PROCESSES envs: the episode
        order table is drawn for the world's envs and sliced by rank, the
        actions are this rank's rows of one global draw, the updates reduce
        over the world, and the stats are gathered to rank 0, which alone
        writes TensorBoard and checkpoints. Under the preemptive sync each
        rollout runs as a prefix of ceil(short_rollout_threshold * T)
        steps, one store check (agreed over the world), then the tail
        unless the world stops; the refit weighs only the rows filled.

        Under TPU.FUSED_CYCLE or PAIRWISE_FUSION the loop is the same with
        the JAX package's routing (module docstring): no pose bank, no
        sync, no sub-banks, no FLOP count."""
        cfg = self.config
        ppo_cfg = self._ppo_config()
        p = cfg.RL.PPO
        device = torch.device(self.device)
        t_setup = time.perf_counter()

        on_cuda = device.type == "cuda"
        fused = bool(cfg.TPU.get("FUSED_CYCLE", False))
        fusion = fusion_knob(cfg.TPU)
        if rir_mode == "sub" and fusion:
            # the JAX package's reason, which its fused programs make true
            raise ValueError(
                "sub-bank mode refreshes the RIR slab per rollout; TPU.FUSED_CYCLE / "
                "PAIRWISE_FUSION fuse whole cycles into one program and cannot host the refresh")
        unroll = int(cfg.TPU.get("COLLECT_UNROLL", 1))
        if unroll != 1:
            logger.info("TPU.COLLECT_UNROLL=%d: the JAX package's unroll of the collect's scan "
                        "changes its compiled program, not its arithmetic; the port's collect "
                        "is a Python loop, which every unroll runs alike", unroll)
        self._rir_mode = rir_mode

        def mark():
            if not on_cuda:
                return time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def secs(a, b):
            return a.elapsed_time(b) * 1e-3 if on_cuda else b - a

        bundle = self._make_bundle()
        rank, _, n_envs, n_global = self._world()
        is_rank0 = world()[0] == 0
        t_steps = p.num_steps
        cycle = p.num_updates_per_cycle
        max_ep_steps = cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS
        gt_norm = cfg.TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM
        action_codes = tuple(int(Action[a]) for a in cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)

        # the RIR-rfft cache in dense mode only, when the dense and rfft
        # banks both fit the gate
        rfft_on = bool(cfg.TPU.PRECOMPUTE_RIR_RFFT) and rir_mode == "dense"
        if rfft_on and de.estimate_bank_bytes(bundle) + de.estimate_rir_rfft_bytes(bundle) > int(
            cfg.TPU.MAX_DEVICE_BANK_BYTES
        ):
            logger.info("PRECOMPUTE_RIR_RFFT: the rfft bank exceeds the gate; "
                        "computing RIR FFTs per step instead")
            rfft_on = False
        dev = de.build_device_bundle(bundle, device, precompute_rir_rfft=rfft_on,
                                     rir_mode=rir_mode)
        # the world's table, seeded by SEED alone, and this rank's rows of it
        order = de.make_order_table(n_global, len(bundle.episodes), cfg.SEED)[
            rank * n_envs: (rank + 1) * n_envs]
        env_state = de.env_reset_all(dev.scene, dev.episodes, torch.as_tensor(order, device=device))
        sub_bank = self._sub_bank = (
            self._make_sub_bank(bundle, dev, order, device) if rir_mode == "sub" else None
        )
        prefetch = sub_bank is not None and bool(cfg.TPU.SUB_PREFETCH)
        self.sub_bank_log = []  # per cycle: the sub-bank's counters over the cycle

        pol_sensors = ["mixed_bin_audio_mag", "target_class"]
        pol_sensors += [k for k, b in (("rgb", dev.rgb_bank), ("depth", dev.depth_bank))
                        if b is not None]

        policy = self._new_policy()
        state = create_agent_state(ppo_cfg, policy)
        update_count, snap = self._load_start_state(policy, state)
        self.mfu_info = None
        report_mfu = bool(cfg.TPU.get("REPORT_MFU", False))
        if report_mfu and world_size() > 1:
            logger.warning("REPORT_MFU: the FLOP count covers a world of one rank only; "
                           "mfu_info stays None")
            report_mfu = False
        elif report_mfu and fusion:
            logger.warning("REPORT_MFU: probe supports single-device separate-program runs "
                           "only; skipping")  # the JAX package's warning
            report_mfu = False
        flops = dict.fromkeys(("collect", "update", "refit"), 0)

        def counted(name, fn, *args, **kwargs):
            """fn(*args, **kwargs), its FLOPs added to flops[name] in the
            first cycle under REPORT_MFU (``mfu_report``)."""
            if not (report_mfu and cycle_idx == 0):
                return fn(*args, **kwargs)
            counter = FlopCounterMode(display=False)
            with counter:
                out = fn(*args, **kwargs)
            flops[name] += counter.get_total_flops()
            return out

        # pose-indexed rollout observations whenever the collect's
        # per-rollout visual-feature bank is active: the update then runs
        # the visual conv stack once per epoch over the S*V*4 poses; the
        # fusion knobs store the frames, as the JAX package's fused programs
        frame_bank = dev.rgb_bank if dev.rgb_bank is not None else dev.depth_bank
        pose_obs = self._pose_obs = (
            not fusion
            and frame_bank is not None
            and policy.pol_net.visual_encoder is not None
            and frame_bank.shape[0] * frame_bank.shape[1] * 4 <= n_envs * t_steps
        )

        def mk_collect(steps):
            return make_collect(
                policy, ppo_cfg, steps, max_ep_steps, gt_norm, p.extra_reward_multiplier,
                action_codes, tuple(pol_sensors), pose_obs=pose_obs,
                sep_rewards=p.sep_reward_weight == 1.0 and p.nav_reward_weight == 0.0,
                nav_reward_scale=(cfg.RL.DISTANCE_REWARD_SCALE if cfg.RL.WITH_DISTANCE_REWARD
                                  else 0.0),
                sample_rows=(rank * n_envs, n_global),
            )

        collect = mk_collect(t_steps)
        # the preemptive sync: a prefix of s0 steps, one store check, the tail
        sync_dev, s0 = None, t_steps
        if self._sync_possible() and not fusion:
            s0 = max(1, int(np.ceil(p.short_rollout_threshold * t_steps)))
            if s0 < t_steps:
                sync_dev = self._make_rollout_sync(t_steps)
                collect_prefix, collect_tail = mk_collect(s0), mk_collect(t_steps - s0)
        update_pol = make_update_pol(policy, ppo_cfg, n_envs, pose_bank=pose_obs)
        update_sep = make_update_sep_from_slabs(
            policy, ppo_cfg, cycle, with_validity=sync_dev is not None,
            refit_dtype=tpu_dtype(cfg.TPU, "SEP_REFIT_DTYPE"))
        pol_banks = {"rgb": dev.rgb_bank, "depth": dev.depth_bank} if pose_obs else None
        # the JAX package's fused cycle hands the refit the collects' own
        # outputs: storage as wide as the parameters (float32, or a float64
        # copy's) holds them, float32 or bfloat16, exactly
        slab_dtype = (torch.promote_types(torch.float32, next(policy.parameters()).dtype)
                      if fused else tpu_dtype(cfg.TPU, "SEP_SLAB_DTYPE"))
        if fused and slab_dtype != tpu_dtype(cfg.TPU, "SEP_SLAB_DTYPE"):
            logger.info("TPU.SEP_SLAB_DTYPE is not applied under TPU.FUSED_CYCLE: the refit "
                        "reads the collects' outputs in their own dtypes")
        sep_buf = RolloutSepIdx.create(t_steps * cycle, n_envs, cfg.NUM_SOUNDS_IN_MIX,
                                       device=device, slab_dtype=slab_dtype)
        hidden = torch.zeros((n_envs, p.hidden_size), device=device)
        masks = torch.ones((n_envs, 1), device=device)
        prev_mem = torch.zeros((n_envs, 512, 32, 1), device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(int(cfg.SEED))
        if snap is not None:
            generator.set_state(snap["extra_state"]["generator"])
            carry = snap.get("carry")
            if carry is not None and carry["hidden"].shape[0] == n_global:
                # this rank's rows of the world's env carry
                mine = {k: v[rank * n_envs: (rank + 1) * n_envs].to(device)
                        for k, v in carry.items()}
                hidden, masks, prev_mem = (mine.pop(k) for k in ("hidden", "masks", "prev_mem"))
                env_state = dataclasses.replace(env_state, **mine)
                if sub_bank is not None:
                    sub_bank.restore(env_state.cursor.cpu().numpy(),
                                     env_state.step_count.cpu().numpy())
            elif carry is not None:
                logger.warning("the interrupted state's env carry holds %d envs, not %d: the "
                               "envs start anew", carry["hidden"].shape[0], n_global)

        win = p.reward_window_size
        windows = {
            k: deque(maxlen=win)
            for k in ("reward", "steps", "mono_l2_last", "mono_l2_all", "mem_l2_last",
                      "mem_l2_all", "bin_l2_all", "ndg", "dg")
        }
        # the stats rank 0 gathers: the process group's envs
        cur_ep = {k: np.zeros((n_envs * world_size(),))
                  for k in ("reward", "step", "bin", "mono", "mem")}
        probs_win = deque(maxlen=win)
        total_env_steps = 0
        self.steady_fps = 0.0
        steady_t0, steady_steps0 = None, 0
        self.loss_log = []  # per cycle: (pol losses (cycle, 3), sep losses (cycle, 3))
        self.cycle_log = []
        self._last_sep_fill = 0
        num_cycles = max(1, (cfg.NUM_UPDATES - update_count) // cycle)
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        tb = TensorboardWriter(cfg.TENSORBOARD_DIR if is_rank0 else "", flush_secs=30)
        stats_interval = max(1, int(cfg.TPU.STATS_FETCH_INTERVAL))
        pending = []  # per cycle not yet fetched: its stats, losses, marks and counts
        comm_mark, calls_mark = COMM["seconds"], COMM["calls"]
        if on_cuda:
            torch.cuda.synchronize(device)
        self.setup_s = time.perf_counter() - t_setup
        t_start = time.time()

        # the lr and clip decay: the fused cycle's float32 formula under
        # FUSED_CYCLE, else the host's float64 one
        decay = linear_decay_float32 if fused else linear_decay
        for cycle_idx in range(num_cycles):
            stats_list, pol_l = [], []
            sep_fill = 0  # rows of sep_buf this cycle's rollouts wrote
            marks = [mark()]  # collect starts, collect ends, update ends, ..., refit ends
            for sub in range(cycle):
                idx = update_count + sub
                lr_scale = decay(idx, cfg.NUM_UPDATES) if p.use_linear_lr_decay else 1.0
                clip_scale = decay(idx, cfg.NUM_UPDATES) if p.use_linear_clip_decay else 1.0
                if sub_bank is not None:
                    slab, table = sub_bank.rollout_inputs()
                    dev = dataclasses.replace(dev, rir_sub_bank=slab, ep_src_row=table)
                if sync_dev is None:
                    out = counted("collect", collect, dev, env_state, hidden, masks, prev_mem,
                                  generator)
                    executed = t_steps
                else:
                    sync_dev.new_rollout()
                    out = collect_prefix(dev, env_state, hidden, masks, prev_mem, generator)
                    if on_cuda:
                        # the store read comes after this rank's prefix ran
                        torch.cuda.synchronize(device)
                    executed = s0
                    # store reads race: the world stops together or not at all
                    if not collective_any(sync_dev.should_stop_early(s0)):
                        out = concat_collect_outputs(
                            out, collect_tail(dev, out.env_state, out.hidden, out.masks,
                                              out.prev_mem_masked, generator), ppo_cfg)
                        executed = t_steps
                    sync_dev.mark_done()
                if sub_bank is not None:
                    sub_bank.advance(executed)
                env_state, hidden, masks, prev_mem = (
                    out.env_state, out.hidden, out.masks, out.prev_mem_masked
                )
                write_sep_slab(sep_buf, out.sep_slab, sep_fill)
                sep_fill += executed
                marks.append(mark())
                pol_l.append(counted("update", update_pol, state, out.rollouts_pol, generator,
                                     lr_scale, clip_scale, banks=pol_banks))
                marks.append(mark())
                stats_list.append(out.stats)
                if prefetch:
                    # the next window's rows, assembled while the device runs
                    # this window's collect and update; their writes queue
                    # behind those on the same stream
                    sub_bank.prefetch()
            sep_lrs = [
                decay(update_count + i, cfg.NUM_UPDATES) if p.use_linear_lr_decay else 1.0
                for i in range(cycle)
            ]
            if sync_dev is None:
                sep_losses = counted("refit", update_sep, state, sep_buf, generator, sep_lrs)
                packed = torch.stack(stats_list)
            else:
                sep_losses = update_sep(state, sep_buf, generator, sep_lrs, fill=sep_fill)
                # the rollouts may differ in length: one step axis
                packed = torch.cat(stats_list)[None]
            marks.append(mark())
            self._last_sep_fill = sep_fill
            if report_mfu and cycle_idx == 0:
                self.mfu_info = mfu_report(flops, cycle, t_steps * cycle * n_envs)
            if sub_bank is not None:
                self._log_sub_bank(sub_bank)
            update_count += cycle
            total_env_steps += sep_fill * n_global
            pending.append({
                "steps_at": total_env_steps, "upd_at": update_count, "packed": packed,
                "pol": torch.stack(pol_l), "sep": sep_losses, "marks": marks,
                "env_steps": sep_fill * n_envs,
                # host seconds in the collectives since the last cycle's end
                "comm_s": COMM["seconds"] - comm_mark, "comm_calls": COMM["calls"] - calls_mark,
            })
            comm_mark, calls_mark = COMM["seconds"], COMM["calls"]

            stop = self._check_preemption(state, update_count, generator, carry={
                **{f: getattr(env_state, f) for f in ("node", "rot", "step_count", "ep",
                                                      "cursor", "prev_geo")},
                "hidden": hidden, "masks": masks, "prev_mem": prev_mem,
            })
            if len(pending) >= stats_interval or cycle_idx == num_cycles - 1 or stop:
                for e in pending:
                    local = e["packed"].cpu().numpy()
                    # the world's (..., N_global, K) stats on rank 0
                    packed = gather_to_rank0(e["packed"], dim=e["packed"].dim() - 2)
                    pol_h, sep_h = e["pol"].cpu().numpy(), e["sep"].cpu().numpy()
                    self.loss_log.append((pol_h, sep_h))
                    m = e["marks"]  # the fetches above waited for every mark
                    self.cycle_log.append({
                        "collect": sum(secs(a, b) for a, b in zip(m[0:-1:2], m[1:-1:2])),
                        "update": sum(secs(a, b) for a, b in zip(m[1:-1:2], m[2:-1:2])),
                        "refit": secs(m[-2], m[-1]),
                        "total": secs(m[0], m[-1]),
                        "env_steps": e["env_steps"],
                        "reward_abs_mean": float(np.abs(unpack_stats(local)["reward"]).mean()),
                        "comm_s": e["comm_s"], "comm_calls": e["comm_calls"],
                    })
                    if not is_rank0:
                        continue
                    st = unpack_stats(packed.cpu().numpy())
                    st_flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in st.items()}
                    self._absorb_stats(st_flat, windows, cur_ep)
                    probs_win.append(st_flat["probs"].mean(axis=(0, 1)))
                    lr_now = p.lr_pol * (
                        linear_decay(e["upd_at"], cfg.NUM_UPDATES) if p.use_linear_lr_decay
                        else 1.0
                    )
                    self._write_tb_scalars(tb, windows, probs_win, pol_h[-1], sep_h[-1],
                                           lr_now, e["steps_at"])
                pending.clear()
                value_loss, action_loss, entropy = pol_h[-1]
                bin_loss, mono_loss, mem_loss = sep_h[-1]
                if is_rank0 and (update_count // cycle) % max(1, cfg.LOG_INTERVAL // cycle) == 0:
                    fps = total_env_steps / max(1e-9, time.time() - t_start)
                    logger.info(
                        "update %d | fps %.1f (steady %.1f) | value %.4f action %.4f "
                        "entropy %.3f | sep bin %.4f mono %.4f mem %.4f | win reward "
                        "%.4f | win mem-L2(last) %.4f",
                        update_count, fps, self.steady_fps, value_loss, action_loss, entropy,
                        bin_loss, mono_loss, mem_loss,
                        float(np.mean(windows["reward"])) if windows["reward"] else 0.0,
                        float(np.mean(windows["mem_l2_last"])) if windows["mem_l2_last"] else 0.0,
                    )
                # steady-state fps, flush to flush: the fetch above waited
                # for the flushed cycles, and the first flush excludes warm-up
                if steady_t0 is None:
                    steady_t0, steady_steps0 = time.time(), total_env_steps
                elif total_env_steps > steady_steps0:
                    self.steady_fps = (total_env_steps - steady_steps0) / (time.time() - steady_t0)

            if is_rank0 and cycle_idx % max(1, cfg.CHECKPOINT_INTERVAL // cycle) == 0:
                self._save(state, update_count, cycle_idx)
            if stop:
                break

        tb.close()
        if not stop:
            if is_rank0:
                self._save(state, update_count, num_cycles)
            self._clear_interrupted_state()
        self.final_policy = policy

    def _log_sub_bank(self, sub_bank: RirSubBank) -> None:
        """Append the sub-bank's counters since the last cycle to
        ``self.sub_bank_log``."""
        now = {
            "rows_assembled": sub_bank.rows_assembled, "rows_uploaded": sub_bank.rows_uploaded,
            "bytes_uploaded": sub_bank.bytes_uploaded,
            "rollout_inputs_s": sub_bank.host_s["rollout_inputs"],
            "prefetch_s": sub_bank.host_s["prefetch"],
            "prefetch_busy_returns": sub_bank.prefetch_busy_returns,
        }
        before = {k: sum(c[k] for c in self.sub_bank_log) for k in now}
        self.sub_bank_log.append({k: v - before[k] for k, v in now.items()})

    # ------------------------------------------------------------------
    def _make_envs(self, bundle):
        """The host envs of the host path (env_utils.py:531-687): a
        multi-scene bundle's scenes go round-robin to the world's envs (at
        least as many scenes as envs; shuffled for a train split), a single
        scene's episodes are split over them when there are enough; this
        rank builds its NUM_PROCESSES envs of them, env i of rank r seeded
        SEED + r * NUM_PROCESSES + i. Worker processes unless USE_SYNC_VECENV
        or not USE_VECENV."""
        cfg = self.config
        rank, _, n, n_global = self._world()
        p = cfg.RL.PPO
        near = p.sep_reward_weight == 1.0 and p.nav_reward_weight == 0.0
        scene_names = list(bundle.scenes)
        if len(scene_names) > 1:
            splits = split_scenes_round_robin(
                scene_names, n_global, shuffle=cfg.TASK_CONFIG.DATASET.SPLIT[:5] == "train",
                seed=cfg.SEED,
            )
            per_env = [bundle.episodes.filter_by_scenes(splits[rank * n + i]) for i in range(n)]
        elif len(bundle.episodes) >= n_global:
            per_env = [bundle.episodes.split_for_rank(rank * n + i, n_global) for i in range(n)]
        else:
            per_env = [bundle.episodes] * n
        env_fns = [
            bundle.make_env_fn(
                max_episode_steps=cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS,
                with_distance_reward=cfg.RL.WITH_DISTANCE_REWARD and not near,
                distance_reward_scale=cfg.RL.DISTANCE_REWARD_SCALE,
                gt_mono_mag_norm=cfg.TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM,
                possible_actions=tuple(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS),
                seed=cfg.SEED + rank * n + i,  # per-env seeds (ppo_trainer.py:605-613)
                episodes=per_env[i],
            )
            for i in range(n)
        ]
        return construct_envs(env_fns, use_sync=cfg.USE_SYNC_VECENV or not cfg.USE_VECENV)

    @staticmethod
    def _host_batch(observations) -> Dict[str, np.ndarray]:
        """The envs' observations stacked along a leading env axis."""
        return {k: np.stack([np.asarray(o[k]) for o in observations]) for k in observations[0]}

    @staticmethod
    def _build_rollout_step(policy: Move2HearPolicy, gt_mono_mag_norm: float, rows=None):
        """One device step per env step: ``step(bank, host, hidden, masks,
        prev_mem_masked, generator)`` (the actions: `rows` of the world's
        global draw) renders the envs' render keys
        (magnitudes only: the loop reads phases only through the same-phase
        STFT-L2), runs the separator chain, the acoustic memory and the
        policy, and returns (obs, pred_masks, pred_mono, pred_mem, act,
        stats) with the separation utility q and the STFT-L2s in stats."""

        @torch.no_grad()
        def step(bank, host, hidden, masks, prev_mem_masked, generator):
            rendered = render_binaural_mixture(
                bank[host["sound_ids"]], host["rirs"], gt_mono_mag_norm=gt_mono_mag_norm,
                mags_only=True,
            )
            obs = {
                "mixed_bin_audio_mag": rendered.mixed_bin_audio_mag,
                "gt_bin_comps": rendered.gt_bin_comps,
                "gt_mono_comps": rendered.gt_mono_comps,
                "target_class": host["target_class"],
            }
            for k in ("rgb", "depth"):
                if k in host:
                    obs[k] = host[k]
            pm = policy.get_binSepMasks(obs)
            mono = policy.convert_bin2mono(pm, obs["mixed_bin_audio_mag"])
            mem = policy.get_monoFromMem(mono, prev_mem_masked)
            act = policy.act(obs, hidden, masks, pm, mono, mem, generator=generator, rows=rows)
            bin_l2, mono_l2 = stft_l2_distance(obs["mixed_bin_audio_mag"], pm,
                                               obs["gt_bin_comps"], mono, obs["gt_mono_comps"])
            _, mem_l2 = stft_l2_distance(obs["mixed_bin_audio_mag"], pm, obs["gt_bin_comps"],
                                         mem, obs["gt_mono_comps"])
            stats = {"q": q_util(mem, obs["gt_mono_comps"][..., 0::2][..., :1]),
                     "bin_l2": bin_l2, "mono_l2": mono_l2, "mem_l2": mem_l2}
            return obs, pm, mono, mem, act, stats

        return step

    def _train_host(self) -> None:
        """The host env path (the JAX package's ``_train_host``): host envs
        step the graph and read the RIRs and frames; per env step the host
        ships the render keys (sound ids, RIRs, target class, frames) to the
        device, which renders, runs the policy forward and the separation
        reward, with one host fetch a step (the next actions and the step's
        stats). Per cycle, num_updates_per_cycle x (num_steps env steps +
        policy update), then num_updates_per_cycle separator refits that
        render anew from the stored keys (``rl/ppo.py:make_update_sep``).
        Separation rewards at (sep 1, nav 0), the env's rewards otherwise.
        Per cycle ``self.cycle_log`` records the seconds in the env step, the
        device step, the policy updates and the refits (host clock; the
        device is synchronised at each phase's end), ``self.loss_log`` the
        losses; ``self.rir_bytes_per_step`` is the RIR bytes a step ships."""
        cfg = self.config
        ppo_cfg = self._ppo_config()
        p = cfg.RL.PPO
        device = torch.device(self.device)
        on_cuda = device.type == "cuda"
        self._rir_mode = "host"
        t_setup = time.perf_counter()
        self.mfu_info = None
        if self.config.TPU.get("REPORT_MFU", False):
            logger.warning("REPORT_MFU: the FLOP count covers the device path's cycle only; "
                           "the host path leaves mfu_info at None")

        def sync():
            if on_cuda:
                torch.cuda.synchronize(device)
            return time.perf_counter()

        bundle = self._make_bundle()
        envs = self._make_envs(bundle)
        self.vector_env = type(envs).__name__
        try:
            self._host_loop(envs, bundle, ppo_cfg, p, device, sync, t_setup)
        finally:
            envs.close()

    def _host_loop(self, envs, bundle, ppo_cfg, p, device, sync, t_setup) -> None:
        cfg = self.config
        rank, _, n_envs, n_global = self._world()
        is_rank0 = world()[0] == 0
        t_steps = p.num_steps
        cycle = p.num_updates_per_cycle
        max_ep_steps = cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS
        gt_norm = cfg.TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM
        sep_rewards = p.sep_reward_weight == 1.0 and p.nav_reward_weight == 0.0

        policy = self._new_policy()
        state = create_agent_state(ppo_cfg, policy)
        update_count, snap = self._load_start_state(policy, state)
        wav_bank = torch.from_numpy(np.asarray(bundle.audio_db.mono_bank(), np.float32)).to(device)
        rollout_step = self._build_rollout_step(policy, gt_norm, rows=(rank * n_envs, n_global))
        # under the preemptive sync a rollout may stop at any step from
        # threshold * T on: the updates weigh only the collected steps
        sync_possible = self._sync_possible()
        update_pol = make_update_pol(policy, ppo_cfg, n_envs, with_validity=sync_possible)
        # the refit renders one rollout's rows (num_steps x envs) at a time
        update_sep = make_update_sep(policy, ppo_cfg, n_envs, gt_mono_mag_norm=gt_norm,
                                     chunk_rows=t_steps, with_validity=sync_possible)
        rollout_sync = self._make_rollout_sync(t_steps) if sync_possible else None
        generator = torch.Generator(device=device)
        generator.manual_seed(int(cfg.SEED))
        if snap is not None:
            # the host envs start anew: their simulators' state is not saved
            generator.set_state(snap["extra_state"]["generator"])

        obs0_host = self._host_batch(envs.reset())
        host = host_obs_to_device(obs0_host, device, batch=False)
        self.rir_bytes_per_step = int(obs0_host["rirs"].nbytes)
        pol_sensors = [k for k in ("mixed_bin_audio_mag", "rgb", "depth", "target_class")
                       if k == "mixed_bin_audio_mag" or k in obs0_host]
        obs_shapes = {"mixed_bin_audio_mag": (512, 32, 2),
                      **{k: obs0_host[k].shape[1:] for k in pol_sensors[1:]}}
        rollouts_pol = create_rollout_pol(t_steps, n_envs, obs_shapes, p.hidden_size,
                                          device=device)
        rollouts_sep = create_rollout_sep(t_steps * cycle, n_envs, cfg.NUM_SOUNDS_IN_MIX,
                                          bundle.audio_db.rir_length, device=device)

        # the initial forward, which seeds slot 0 of both storages
        masks_now = torch.ones((n_envs, 1), device=device)
        cur_obs, cur_pm, cur_mono, cur_mem, cur_act, cur_stats = rollout_step(
            wav_bank, host, torch.zeros((n_envs, p.hidden_size), device=device), masks_now,
            torch.zeros((n_envs, 512, 32, 1), device=device), generator,
        )
        for k in pol_sensors:
            rollouts_pol.observations[k][0].copy_(cur_obs[k])
        for k in ("sound_ids", "rirs", "target_class"):
            getattr(rollouts_sep, k)[0].copy_(host[k])
        host_actions = cur_act.action[:, 0].cpu().numpy()

        win = p.reward_window_size
        windows = {
            k: deque(maxlen=win)
            for k in ("reward", "steps", "mono_l2_last", "mono_l2_all", "mem_l2_last",
                      "mem_l2_all", "bin_l2_all", "ndg", "dg")
        }
        # the stats rank 0 gathers: the process group's envs
        cur_ep = {k: np.zeros((n_envs * world_size(),))
                  for k in ("reward", "step", "bin", "mono", "mem")}
        ep_step0 = 0  # env 0's episode step, which keys the reward's bonus
        probs_win = deque(maxlen=win)
        tb = TensorboardWriter(cfg.TENSORBOARD_DIR if is_rank0 else "", flush_secs=30)
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        self.loss_log, self.cycle_log = [], []
        self.steady_fps = 0.0
        steady_t0, steady_steps0 = None, 0
        total_env_steps = 0
        num_cycles = max(1, (cfg.NUM_UPDATES - update_count) // cycle)
        self.setup_s = sync() - t_setup
        comm_mark = COMM["seconds"]

        def decay(i):
            return linear_decay(i, cfg.NUM_UPDATES)

        for cycle_idx in range(num_cycles):
            secs = dict.fromkeys(("env", "device_step", "update", "refit"), 0.0)
            pol_l, step_rows = [], []
            t_cycle = time.perf_counter()
            sep_step = 0
            for sub in range(cycle):
                idx = update_count + sub
                if sync_possible:
                    rollout_sync.new_rollout()
                for step_t in range(t_steps):
                    t0 = time.perf_counter()
                    outputs = envs.step([int(a) for a in host_actions])
                    t1 = time.perf_counter()
                    secs["env"] += t1 - t0
                    obs_list, env_rewards, dones, infos = (list(x) for x in zip(*outputs))
                    host = host_obs_to_device(self._host_batch(obs_list), device, batch=False)
                    masks_next = torch.tensor([[0.0] if d else [1.0] for d in dones],
                                              device=device)
                    prev_mem = cur_mem * masks_next[:, :, None, None]
                    nxt = rollout_step(wav_bank, host, cur_act.hidden, masks_next, prev_mem,
                                       generator)
                    next_obs, next_pm, next_mono, next_mem, next_act, next_stats = nxt
                    # this step's reward, final once the next q is known
                    if sep_rewards:
                        # the bonus keys on env 0's episode step, as the
                        # reference's current_episode_step[0] (ppo_trainer.py:395)
                        rewards = sep_reward(
                            cur_stats["q"], next_stats["q"], masks_next[:, 0],
                            ep_step0 == max_ep_steps - 2, p.extra_reward_multiplier,
                        )[:, None]
                    else:
                        rewards = torch.tensor(np.asarray(env_rewards, np.float32),
                                               device=device)[:, None]
                    ep_step0 = 0 if dones[0] else ep_step0 + 1
                    # one host fetch a step: the next actions and the stats
                    fetched = torch.cat([
                        next_act.action.to(torch.float32), rewards, cur_stats["bin_l2"],
                        cur_stats["mono_l2"], cur_stats["mem_l2"], next_act.probs,
                    ], dim=1).cpu().numpy()
                    host_actions = fetched[:, 0].astype(np.int64)
                    step_rows.append(np.concatenate([
                        fetched[:, 1:], np.asarray(dones, np.float64)[:, None],
                        np.asarray([[i["normalized_geo_distance_to_target_audio_source"],
                                     i["geo_distance_to_target_audio_source"]]
                                    for i in infos], np.float64),
                    ], axis=1))

                    insert_pol(rollouts_pol, step_t, {k: next_obs[k] for k in pol_sensors},
                               cur_act.hidden, cur_act.action, cur_act.action_log_probs,
                               cur_act.value, rewards, masks_next, cur_pm, cur_mono, cur_mem)
                    insert_sep(rollouts_sep, sep_step, host["sound_ids"], host["rirs"],
                               host["target_class"], masks_next, cur_mem)
                    sep_step += 1
                    cur_obs, cur_pm, cur_mono, cur_mem, cur_act, cur_stats = nxt
                    total_env_steps += n_envs
                    secs["device_step"] += time.perf_counter() - t1
                    t_col = step_t + 1
                    # store reads race: the world cuts at the same step
                    if (sync_possible and t_col >= p.short_rollout_threshold * t_steps
                            and collective_any(rollout_sync.should_stop_early(t_col))):
                        break
                if sync_possible:
                    rollout_sync.mark_done()

                # policy update
                t2 = time.perf_counter()
                t_valid = t_col if sync_possible else None
                rollouts_pol.value_preds[t_col].copy_(cur_act.value)
                rollouts_pol.returns.copy_(compute_returns(
                    rollouts_pol.rewards, rollouts_pol.value_preds, rollouts_pol.masks,
                    ppo_cfg.gamma, ppo_cfg.tau, ppo_cfg.use_gae, t_valid=t_valid,
                ))
                pol_l.append(update_pol(
                    state, rollouts_pol.as_dict(), generator,
                    decay(idx) if p.use_linear_lr_decay else 1.0,
                    decay(idx) if p.use_linear_clip_decay else 1.0, t_valid=t_valid,
                ))
                after_update_pol(rollouts_pol, t_valid)
                secs["update"] += sync() - t2

            # separator refit (ppo_trainer.py:979-994); under the sync the
            # rows past the cycle's last filled one weigh nothing (the
            # boundary row rolls into slot 0 and trains next cycle)
            t3 = time.perf_counter()
            row_w = None
            if sync_possible:
                row_w = (torch.arange(rollouts_sep.masks.shape[0] - 1, device=device)
                         < sep_step).to(torch.float32)
            sep_l = [
                update_sep(state, rollouts_sep.as_dict(), wav_bank, generator,
                           decay(update_count + i) if p.use_linear_lr_decay else 1.0,
                           row_weights=row_w)
                for i in range(cycle)
            ]
            after_update_sep(rollouts_sep, sep_step if sync_possible else None)
            self._last_sep_fill = sep_step
            pol_h = torch.stack(pol_l).cpu().numpy()
            sep_h = torch.stack(sep_l).cpu().numpy()
            secs["refit"] = sync() - t3
            update_count += cycle
            self.loss_log.append((pol_h, sep_h))
            # the cycle's per-step stats, (steps, N, K), of the world on rank 0
            rows = gather_to_rank0(torch.from_numpy(np.stack(step_rows)), dim=1)
            self.cycle_log.append({
                **secs, "total": time.perf_counter() - t_cycle,
                "env_steps": sep_step * n_envs,
                "reward_abs_mean": float(np.mean(np.abs(np.stack(step_rows)[..., 0]))),
                "comm_s": COMM["seconds"] - comm_mark,
            })
            comm_mark = COMM["seconds"]
            if is_rank0:
                rows = rows.numpy()
                na = rows.shape[-1] - 7
                self._absorb_stats({
                    "q": rows[..., 0], "reward": rows[..., 0], "bin_l2": rows[..., 1],
                    "mono_l2": rows[..., 2], "mem_l2": rows[..., 3],
                    "done": rows[..., 4 + na], "ndg": rows[..., 5 + na], "geo": rows[..., 6 + na],
                }, windows, cur_ep)
                probs_win.extend(rows[..., 4: 4 + na].mean(axis=1))
                steps_now = update_count * t_steps * n_global
                lr_now = p.lr_pol * (decay(update_count) if p.use_linear_lr_decay else 1.0)
                self._write_tb_scalars(tb, windows, probs_win, pol_h[-1], sep_h[-1], lr_now,
                                       steps_now)
            if is_rank0 and (update_count // cycle) % max(1, cfg.LOG_INTERVAL // cycle) == 0:
                value_loss, action_loss, entropy = pol_h[-1]
                logger.info(
                    "update %d | env t %.1f | dev t %.1f | value %.4f action %.4f entropy "
                    "%.3f | sep bin %.4f mono %.4f mem %.4f | win reward %.4f",
                    update_count, secs["env"], secs["device_step"], value_loss, action_loss,
                    entropy, *sep_h[-1],
                    float(np.mean(windows["reward"])) if windows["reward"] else 0.0,
                )
            # steady-state fps from the end of the first cycle on
            if steady_t0 is None:
                steady_t0, steady_steps0 = time.time(), total_env_steps
            else:
                self.steady_fps = (total_env_steps - steady_steps0) / (time.time() - steady_t0)
            if is_rank0 and cycle_idx % max(1, cfg.CHECKPOINT_INTERVAL // cycle) == 0:
                self._save(state, update_count, cycle_idx)
            stop = self._check_preemption(state, update_count, generator)
            if stop:
                break

        tb.close()
        if not stop:
            if is_rank0:
                self._save(state, update_count, num_cycles)
            self._clear_interrupted_state()
        self._windows = windows
        self.final_policy = policy

    # ------------------------------------------------------------------
    def _write_tb_scalars(self, tb, windows, probs_win, pol_losses, sep_losses, lr_now, step):
        """The reference's per-update training scalars (ppo_trainer.py:905-957)
        and the separator refit losses."""
        def wmean(k):
            return float(np.mean(windows[k])) if len(windows[k]) else 0.0

        tb.add_scalar("Environment/Reward", wmean("reward"), step)
        tb.add_scalar("Environment/Episode_length", wmean("steps"), step)
        if probs_win:
            for i, v in enumerate(np.mean(np.stack(list(probs_win)), axis=0)):
                tb.add_scalar(f"Policy/Action_prob_{i}", float(v), step)
        for tag, k in (("mono_lastStep", "mono_l2_last"), ("mono_avgAllSteps", "mono_l2_all"),
                       ("monoFromMem_lastStep", "mem_l2_last"),
                       ("monoFromMem_avgAllSteps", "mem_l2_all")):
            tb.add_scalar(f"Environment/STFT_L2_loss/{tag}", wmean(k), step)
        tb.add_scalar("Environment/Normalized_geo_distance_to_target_audio_source",
                      wmean("ndg"), step)
        tb.add_scalar("Environment/Geo_distance_to_target_audio_source", wmean("dg"), step)
        value_loss, action_loss, entropy = pol_losses
        tb.add_scalar("Policy/Value_Loss", float(value_loss), step)
        tb.add_scalar("Policy/Action_Loss", float(action_loss), step)
        tb.add_scalar("Policy/Entropy", float(entropy), step)
        tb.add_scalar("Policy/Learning_Rate", float(lr_now), step)
        if sep_losses is None:
            return
        bin_loss, mono_loss, mem_loss = sep_losses
        tb.add_scalar("Separator/Bin_Loss", float(bin_loss), step)
        tb.add_scalar("Separator/Mono_Loss", float(mono_loss), step)
        tb.add_scalar("Separator/MonoFromMem_Loss", float(mem_loss), step)

    @staticmethod
    def _absorb_stats(st, windows, cur_ep):
        """Fold the unpacked (T_total, N) stat stacks into the reference's
        windowed episode statistics (ppo_trainer.py:426-455); the host path
        folds each step as T_total = 1."""
        for t in range(st["q"].shape[0]):
            done = st["done"][t].astype(bool)
            cur_ep["reward"] += st["reward"][t]
            cur_ep["step"] += 1
            cur_ep["bin"] += st["bin_l2"][t]
            cur_ep["mono"] += st["mono_l2"][t]
            cur_ep["mem"] += st["mem_l2"][t]
            if done.any():
                steps_i = np.maximum(cur_ep["step"][done], 1)
                windows["reward"].extend(cur_ep["reward"][done])
                windows["steps"].extend(steps_i)
                windows["bin_l2_all"].extend(cur_ep["bin"][done] / steps_i)
                windows["mono_l2_all"].extend(cur_ep["mono"][done] / steps_i)
                windows["mem_l2_all"].extend(cur_ep["mem"][done] / steps_i)
                windows["mono_l2_last"].extend(st["mono_l2"][t, done])
                windows["mem_l2_last"].extend(st["mem_l2"][t, done])
                windows["ndg"].extend(st["ndg"][t, done])
                windows["dg"].extend(st["geo"][t, done])
                for k in cur_ep:
                    cur_ep[k][done] = 0.0

    def _save(self, state, update_count, ckpt_idx):
        """The port's training checkpoint (``utils/checkpoint.py``): the
        evaluator reads ``state_dict`` and ``config``; ``RESUME_CKPT`` reads
        all of it."""
        save_checkpoint(
            os.path.join(self.config.CHECKPOINT_FOLDER, f"ckpt.{ckpt_idx}.pth"),
            {
                "state_dict": state.policy.state_dict(),
                "config": self.config.to_dict(),
                "optimizer_pol": state.opt_pol.state_dict(),
                "optimizer_sep": state.opt_sep.state_dict(),
                "extra_state": {"update_count": update_count},
            },
        )

    # ------------------------------------------------------------------
    def _eval_checkpoint(self, checkpoint_path: str, checkpoint_index: int = 0):
        """Merge the checkpoint's saved config per EVAL.USE_CKPT_CONFIG
        (switch-policy eval reads the nav policy's config), then route
        (rl/trainer.py:1839-1895 of the JAX package): the batched device
        evaluator when TPU.DEVICE_ENV is set, at least
        TPU.DEVICE_EVAL_MIN_EPISODES episodes are asked for and the bundle's
        device banks fit TPU.MAX_DEVICE_BANK_BYTES; the host evaluator
        otherwise."""
        cfg = self.config
        ckpt = load_checkpoint(checkpoint_path)
        if cfg.RL.PPO.switch_policy:
            nav_cfg = ckpt.get("config_nav")
            config = self._setup_eval_config(nav_cfg, cfg) if nav_cfg else cfg
        elif cfg.EVAL.USE_CKPT_CONFIG and ckpt.get("config"):
            config = self._setup_eval_config(ckpt["config"], cfg)
        else:
            config = cfg
        refuse_unported_knobs(config.TPU, training=False)

        # file-backed data resolves against the MERGED eval config: its
        # DATASET.SPLIT and MONO_DIR may differ from the train config's (the
        # unheard presets repoint both)
        bundle = self._bundle
        if bundle is None and has_file_backed_data(config.TASK_CONFIG):
            bundle = bundle_from_config(config.TASK_CONFIG,
                                        max_rir_length=config.TPU.MAX_RIR_LENGTH)
        n_eps = config.get("EVAL_EPISODE_COUNT", config.EVAL.EPISODE_COUNT)
        use_device = (
            config.TPU.DEVICE_ENV
            and n_eps >= config.TPU.DEVICE_EVAL_MIN_EPISODES
        )
        if use_device and bundle is not None:
            use_device = de.estimate_bank_bytes(bundle) <= int(config.TPU.MAX_DEVICE_BANK_BYTES)
        self._eval_route = "device" if use_device else "host"
        evaluate = evaluate_checkpoint_device if use_device else evaluate_checkpoint
        timings = {}
        agg = evaluate(config, checkpoint_path, checkpoint_index, bundle=bundle,
                       device=self.device, timings=timings)
        self.last_eval = (agg, timings)
        logger.info(
            "checkpoint %d (%s evaluator): %d episodes, %d env-steps in %.3f s (set-up %.3f s)",
            checkpoint_index, self._eval_route, timings["episodes"], timings["env_steps"],
            timings["loop_s"], timings["setup_s"],
        )
        return agg

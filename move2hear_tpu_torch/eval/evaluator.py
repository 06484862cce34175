"""The host evaluator (``ppo_trainer.py:1015-1549``; the JAX package's
``eval/evaluator.py:evaluate_checkpoint``): one host env (env/environment.py
over the bundle's scenes, file-backed or synthetic) plays the episodes one
after another; each step ships its render keys (sound ids, the RIRs of the
pose, the target class and the frames) to the device, which renders the
mixture, runs the separators, the acoustic memory and the policy, and
returns the action and the step's STFT-L2 in one fetch. With
COMPUTE_EVAL_METRICS the step's spectrograms come back too and the SI-SDR
family is computed on the host (eval/bss.py, a numpy ISTFT).

The far-target POLICY SWITCH runs the navigation policy for the first
``time_thres_for_pol_switch`` steps of an episode and the
quality-improvement policy after, each with its own GRU hidden state; the
acoustic-memory chain continues across the switch, as in the reference
(ppo_trainer.py:1093-1129,1230-1339).

Outputs: ``{split}_stats_ckpt_{i}_{seed}.json`` (mean and std of each
per-episode measure) and ``eval_metrics_ckpt_{i}.pkl`` (per-episode,
per-step metrics) under MODEL_DIR, in the device evaluator's layout. A step
launches masked_mix_slice16 twice at B=1 (the bin2mono encoder and the
policy's bin encoder) and overlap_add never.

The trainer routes an evaluation here when TPU.DEVICE_ENV is off, when
fewer than TPU.DEVICE_EVAL_MIN_EPISODES episodes are asked for, or when the
bundle's device banks exceed TPU.MAX_DEVICE_BANK_BYTES
(``rl/trainer.py:PPOTrainer._eval_checkpoint``).
"""

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from move2hear_tpu_torch.eval.bss import compute_waveform_quality
from move2hear_tpu_torch.eval.device_evaluator import (
    default_eval_bundle,
    eval_episodes_of,
    eval_policies,
    per_goal_distance_columns,
    write_eval_outputs,
)
from move2hear_tpu_torch.eval.metrics import stft_l2_distance
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from move2hear_tpu_torch.utils.misc import tpu_dtype
from move2hear_tpu_torch.utils.tb import TensorboardWriter

logger = logging.getLogger(__name__)


def make_host_eval_step(gt_mono_mag_norm: float, deterministic: bool):
    """``step(policy, bank, host, hidden, masks, prev_mem, generator)`` for
    one env: render, separators, memory, act and the step's STFT-L2 on the
    device. `host` holds the step's observations as device tensors with a
    batch axis of 1. Returns (obs, rendered, pred_mono, pred_mem, act,
    (bin_l2, mono_l2, mem_l2)). Call it under ``torch.inference_mode()``."""

    def step(policy, bank, host, hidden, masks, prev_mem, generator):
        rendered = render_binaural_mixture(
            bank[host["sound_ids"]], host["rirs"], gt_mono_mag_norm=gt_mono_mag_norm,
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
        mem = policy.get_monoFromMem(mono, prev_mem)
        act = policy.act(obs, hidden, masks, pm, mono, mem, generator=generator,
                         deterministic=deterministic)
        bin_l2, mono_l2 = stft_l2_distance(obs["mixed_bin_audio_mag"], pm, obs["gt_bin_comps"],
                                           mono, obs["gt_mono_comps"])
        _, mem_l2 = stft_l2_distance(obs["mixed_bin_audio_mag"], pm, obs["gt_bin_comps"],
                                     mem, obs["gt_mono_comps"])
        return obs, rendered, mono, mem, act, (bin_l2, mono_l2, mem_l2)

    return step


def host_obs_to_device(obs: Dict[str, np.ndarray], device, batch: bool = True):
    """Host observations as device tensors: rgb stays uint8, integers become
    int64 (indices), floats float32. `batch` adds a leading axis of 1 (one
    env); without it `obs` already holds stacked arrays."""
    out = {}
    for k, v in obs.items():
        a = np.asarray(v)[None] if batch else np.asarray(v)
        if a.dtype == np.uint8:
            t = torch.from_numpy(a)
        elif a.dtype.kind in "iu":
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(a.astype(np.float32, copy=False))
        out[k] = t.to(device, non_blocking=True)
    return out


def evaluate_checkpoint(
    config,
    checkpoint_path: str,
    checkpoint_index: int = 0,
    bundle=None,
    episode_count: Optional[int] = None,
    device="cuda",
    timings: Optional[dict] = None,
    actions_out: Optional[dict] = None,
) -> Dict:
    """Evaluate a checkpoint episode by episode on one host env; returns the
    aggregates. `timings`, if given, receives the set-up and episode-loop
    seconds and the episode and env-step counts; `actions_out`, if given,
    each episode's actions by (scene, episode id)."""
    t_setup = time.perf_counter()
    cfg = config
    p = cfg.RL.PPO
    switch = p.switch_policy
    device = torch.device(device)
    possible_actions = tuple(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)
    dtype = tpu_dtype(cfg.TPU, "COMPUTE_DTYPE")
    policy_nav, policy_qi = eval_policies(cfg, load_checkpoint(checkpoint_path),
                                          len(possible_actions), device, dtype)
    logger.info("host evaluator: %s compute (TPU.COMPUTE_DTYPE)", str(dtype).replace("torch.", ""))
    if bundle is None:
        bundle = default_eval_bundle(cfg)
    episodes = eval_episodes_of(cfg, bundle)

    gt_norm = cfg.TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM
    env = bundle.make_env_fn(
        episodes=episodes if len(episodes) else None,
        max_episode_steps=cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS,
        with_distance_reward=False,
        eval_mode=True,
        gt_mono_mag_norm=gt_norm,
        possible_actions=possible_actions,
        seed=cfg.SEED,
        shuffle_episodes=False,
    )()
    bank = torch.from_numpy(np.asarray(bundle.audio_db.mono_bank(), np.float32)).to(device)
    step = make_host_eval_step(gt_norm, bool(p.deterministic_eval))
    hidden_size = p.hidden_size
    n_episodes = episode_count or min(
        cfg.get("EVAL_EPISODE_COUNT", cfg.EVAL.EPISODE_COUNT), env.number_of_episodes()
    )
    time_thres = p.time_thres_for_pol_switch
    generator = torch.Generator(device=device)
    generator.manual_seed(int(cfg.SEED))

    video_option = list(cfg.get("VIDEO_OPTION", []) or [])
    tb_writer = TensorboardWriter(cfg.TENSORBOARD_DIR) if "tensorboard" in video_option else None

    stats_episodes, eval_metrics_dump = {}, {}
    obs_host = env.reset()
    zeros_hidden = torch.zeros((1, hidden_size), device=device)
    hidden_nav = hidden_qi = zeros_hidden
    masks = torch.zeros((1, 1), device=device)
    prev_mem = torch.zeros((1, 512, 32, 1), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_loop = time.perf_counter()
    env_steps = 0

    for _ in range(n_episodes):
        episode = env.current_episode
        ep_steps = 0
        ep_metrics = {"mono_l2": [], "mem_l2": [], "bin_l2": [], "quality": []}
        actions = []
        frames = [] if video_option else None
        done = False
        while not done:
            use_nav = not switch or ep_steps < time_thres
            policy, hidden = (policy_nav, hidden_nav) if use_nav else (policy_qi, hidden_qi)
            with torch.inference_mode():
                obs, rendered, mono, mem, act, l2s = step(
                    policy, bank, host_obs_to_device(obs_host, device), hidden, masks,
                    prev_mem, generator,
                )
                # one fetch a step: the action and the three STFT-L2
                fetched = torch.cat([act.action.to(torch.float32)] + list(l2s), dim=1)
                if cfg.COMPUTE_EVAL_METRICS:
                    gm = obs["gt_mono_comps"]
                    spect_t = torch.cat([
                        torch.expm1(obs["mixed_bin_audio_mag"]), rendered.mixed_bin_audio_phase,
                        gm[..., 0:1], gm[..., 1:2], mono, mem,
                    ], dim=-1).cpu().numpy()
                fetched = fetched.cpu().numpy()[0]
            if use_nav:
                hidden_nav = act.hidden
            else:
                hidden_qi = act.hidden
            action, bin_l2, mono_l2, mem_l2 = int(fetched[0]), *map(float, fetched[1:])
            actions.append(action)
            ep_metrics["bin_l2"].append(bin_l2)
            ep_metrics["mono_l2"].append(mono_l2)
            ep_metrics["mem_l2"].append(mem_l2)
            if cfg.COMPUTE_EVAL_METRICS:
                spects = {
                    "mixed_bin_audio_mag": spect_t[..., 0:2],
                    "mixed_bin_audio_phase": spect_t[..., 2:4],
                    "gt_mono_mag": spect_t[..., 4:5],
                    "gt_mono_phase": spect_t[..., 5:6],
                    "pred_mono": spect_t[..., 6:7],
                    "pred_monoFromMem": spect_t[..., 7:8],
                }
                ep_metrics["quality"].append(
                    compute_waveform_quality(spects, cfg.EVAL_METRICS_TO_COMPUTE)
                )
            if frames is not None and "rgb" in obs_host:
                frames.append(np.asarray(obs_host["rgb"], np.uint8))

            obs_host, _, done, info = env.step(action)
            ep_steps += 1
            env_steps += 1
            masks = torch.full((1, 1), 0.0 if done else 1.0, device=device)
            prev_mem = mem * masks[:, :, None, None]

        stats_episodes[(episode.scene_id, episode.episode_id)] = {
            "mono_l2_last": ep_metrics["mono_l2"][-1],
            "mono_l2_all": float(np.mean(ep_metrics["mono_l2"])),
            "mem_l2_last": ep_metrics["mem_l2"][-1],
            "mem_l2_all": float(np.mean(ep_metrics["mem_l2"])),
            "bin_l2_all": float(np.mean(ep_metrics["bin_l2"])),
            **info,
            **per_goal_distance_columns(bundle.scenes[episode.scene_id], episode),
        }
        eval_metrics_dump[(episode.scene_id, episode.episode_id)] = ep_metrics
        if actions_out is not None:
            actions_out[(episode.scene_id, episode.episode_id)] = actions
        if frames:
            if tb_writer is not None:
                tb_writer.add_video_from_np_images(
                    f"episode_{episode.scene_id}_{episode.episode_id}", checkpoint_index,
                    frames, fps=4,
                )
            if "disk" in video_option:
                vid_dir = os.path.join(cfg.MODEL_DIR or ".", "videos")
                os.makedirs(vid_dir, exist_ok=True)
                np.save(os.path.join(vid_dir, f"ep_{episode.scene_id}_{episode.episode_id}.npy"),
                        np.stack(frames))
        hidden_nav = hidden_qi = zeros_hidden
    t_end = time.perf_counter()
    if tb_writer is not None:
        tb_writer.close()

    agg = write_eval_outputs(cfg, checkpoint_index, stats_episodes, eval_metrics_dump)
    if timings is not None:
        timings.update(setup_s=t_loop - t_setup, loop_s=t_end - t_loop,
                       episodes=n_episodes, env_steps=env_steps)
    logger.info(
        "eval ckpt %s: mono L2 last %.4f±%.4f | monoFromMem L2 last %.4f±%.4f",
        checkpoint_index, agg["mono_l2_last"]["mean"], agg["mono_l2_last"]["std"],
        agg["mem_l2_last"]["mean"], agg["mem_l2_last"]["std"],
    )
    return agg

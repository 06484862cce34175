"""Batched on-device checkpoint evaluation.

N eval envs run in parallel on the device, one Python loop iteration per
env step over the whole episode horizon. Per-episode metrics (STFT-L2
last/all-step, and the SI-SDR family on ISTFT'd waveforms) are computed on
the device and fetched once per batch of episodes.

Policy switching (far-target eval): both policies are resident; steps
before ``time_thres`` use the nav policy and later ones the quality-
improvement policy, each with its own GRU hidden state
(ppo_trainer.py:1230-1339).

SI-SDR/SD-SDR/SNR/SRR and their improvements are computed from GT-phase
reconstructions (eval_metrics.py:232-303); with a single reference source
SI-SIR/SI-SAR reduce to projections. Mean-centering and the mixture downmix
follow eval_metrics.py:172-199.
"""

import json
import logging
import os
import pickle
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

import move2hear_tpu_torch.env.device_env as de
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.env.sim import Action
from move2hear_tpu_torch.eval.metrics import stft_l2_distance
from move2hear_tpu_torch.models.policy import Move2HearPolicy
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture_pre
from move2hear_tpu_torch.ops.stft import istft_mag_phase
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint
from move2hear_tpu_torch.utils.torch_import import refuse_reference_layout

logger = logging.getLogger(__name__)

SI_METRIC_NAMES = [
    "si_sdr", "si_sir", "si_sar", "sd_sdr", "snr", "srr",
    "si_sdri", "sd_sdri", "snri", "si_siri", "si_sari",
]


def _si_metrics(reference, estimate, mixture):
    """Scale-invariant metric family, single reference source, for a batch
    of envs: (B, L) each -> (B, 11) in SI_METRIC_NAMES order
    (eval_metrics.py:12-122)."""
    eps = 1e-13
    ref = reference - reference.mean(-1, keepdim=True)
    est = estimate - estimate.mean(-1, keepdim=True)
    mix = mixture - mixture.mean(-1, keepdim=True)
    ref_energy = torch.sum(ref**2, -1)
    src_energy = ref_energy + eps

    def db_ratio(num, den):
        return 10 * torch.log10(num / (den + eps) + eps)

    def one(est_v):
        alpha = torch.sum(ref * est_v, -1) / src_energy
        snr = db_ratio(ref_energy, torch.sum((est_v - ref) ** 2, -1))
        e_true = alpha[:, None] * ref
        e_res = est_v - e_true
        true_energy = torch.sum(e_true**2, -1)
        si_sdr = db_ratio(true_energy, torch.sum(e_res**2, -1))
        srr = -10 * torch.log10((1 - 1 / (alpha + eps)) ** 2 + eps)
        sd_sdr = snr + 10 * torch.log10(alpha**2 + eps)
        beta = torch.sum(ref * e_res, -1) / src_energy
        e_interf = beta[:, None] * ref
        si_sir = db_ratio(true_energy, torch.sum(e_interf**2, -1))
        si_sar = db_ratio(true_energy, torch.sum((e_res - e_interf) ** 2, -1))
        return torch.stack([si_sdr, si_sir, si_sar, sd_sdr, snr, srr], -1)

    e, m = one(est), one(mix)
    improvements = torch.stack(
        [e[:, 0] - m[:, 0], e[:, 3] - m[:, 3], e[:, 4] - m[:, 4],
         e[:, 1] - m[:, 1], e[:, 2] - m[:, 2]], -1,
    )
    return torch.cat([e, improvements], -1)


def per_goal_distance_columns(scene, episode) -> Dict[str, float]:
    """Per-goal start->goal distance columns of the reference's eval dump
    (ppo_trainer.py:1446-1478): ``geodesic_distance_{i}`` from the episode's
    own info when present, from the scene graph otherwise, and
    ``euclidean_distance_{i}`` = ||goal_pos - start_pos||."""
    cols: Dict[str, float] = {}
    geos = episode.all_geodesic_distances
    start = int(episode.start_node)
    for gi, src in enumerate(episode.source_nodes):
        src = int(src)
        if geos is not None and gi < len(geos):
            g = float(geos[gi])
        elif gi == 0 and episode.geodesic_distance:
            g = float(episode.geodesic_distance)
        else:
            g = float(scene.geodesic_distance(start, src))
        cols[f"geodesic_distance_{gi}"] = g
        cols[f"euclidean_distance_{gi}"] = float(
            np.linalg.norm(scene.positions[src] - scene.positions[start])
        )
    return cols


def make_device_eval(
    policy_nav: Move2HearPolicy,
    policy_qi: Move2HearPolicy,
    max_episode_steps: int,
    gt_mono_mag_norm: float,
    action_codes,
    deterministic: bool,
    switch_policy: bool = False,
    time_thres: int = 80,
    compute_waveform_metrics: bool = False,
):
    """A function evaluating one full episode horizon for N envs in
    parallel: ``eval_episodes(dev, env_state, generator)`` returns
    (final env state, per-env aggregates, per-step (T, N, ...) outputs).
    Call it under ``torch.inference_mode()``."""

    def forward(policy, obs, prev_mem):
        pm = policy.get_binSepMasks(obs)
        mono = policy.convert_bin2mono(pm, obs["mixed_bin_audio_mag"])
        return pm, mono, policy.get_monoFromMem(mono, prev_mem)

    def eval_episodes(dev: de.DeviceBundle, env_state: de.DeviceEnvState,
                      generator: Optional[torch.Generator]):
        device = env_state.node.device
        codes = torch.as_tensor(action_codes, dtype=torch.long, device=device)
        n = env_state.node.shape[0]
        hid = policy_nav.hidden_size

        # per-pose visual-feature banks: one conv batch over the S*V*4 poses
        # per policy instead of the conv stack on every step's frames
        vis_nav = vis_qi = None
        frame_bank = dev.rgb_bank if dev.rgb_bank is not None else dev.depth_bank
        if frame_bank is not None and policy_nav.pol_net.visual_encoder is not None:
            s_sc, v_nodes = frame_bank.shape[0], frame_bank.shape[1]
            if s_sc * v_nodes * 4 <= n * max_episode_steps:
                def flat(b):
                    return None if b is None else b.reshape((-1,) + b.shape[3:])

                vis_nav = policy_nav.visual_features(flat(dev.rgb_bank), flat(dev.depth_bank))
                if switch_policy:
                    vis_qi = policy_qi.visual_features(flat(dev.rgb_bank), flat(dev.depth_bank))

        hidden_nav = torch.zeros((n, hid), device=device)
        hidden_qi = torch.zeros((n, hid), device=device)
        masks = torch.ones((n, 1), device=device)
        prev_mem = torch.zeros((n, 512, 32, 1), device=device)
        steps = []
        for step_i in range(max_episode_steps):
            obs_idx = de.observe(dev.episodes, env_state)
            sensors = de.gather_sensors(dev, obs_idx)
            rendered = render_binaural_mixture_pre(
                sensors["mono_rfft"], sensors.get("rirs"),
                sensors["gt_mono_raw"], sensors["mono_len"],
                gt_mono_mag_norm=gt_mono_mag_norm,
                rir_rfft=sensors.get("rir_rfft"),
                rir_len=sensors.get("rir_len", 0),
            )
            obs = {
                "mixed_bin_audio_mag": rendered.mixed_bin_audio_mag,
                "gt_bin_comps": rendered.gt_bin_comps,
                "gt_mono_comps": rendered.gt_mono_comps,
                "target_class": sensors["target_class"],
            }
            for k in ("rgb", "depth"):
                if k in sensors:
                    obs[k] = sensors[k]

            use_nav = not switch_policy or step_i < time_thres
            policy, vis, hidden = (
                (policy_nav, vis_nav, hidden_nav) if use_nav
                else (policy_qi, vis_qi, hidden_qi)
            )
            if vis is not None:
                pose = (obs_idx.scene_idx * frame_bank.shape[1] + obs_idx.node) * 4 + obs_idx.rot_idx
                obs_act = {**obs, "visual_feats": vis[pose]}
            else:
                obs_act = obs
            pm, mono, mem = forward(policy, obs, prev_mem)
            act = policy.act(obs_act, hidden, masks, pm, mono, mem,
                             generator=generator, deterministic=deterministic)
            if use_nav:
                hidden_nav = act.hidden
            else:
                hidden_qi = act.hidden

            bin_l2, mono_l2 = stft_l2_distance(
                obs["mixed_bin_audio_mag"], pm, obs["gt_bin_comps"],
                mono, obs["gt_mono_comps"],
            )
            _, mem_l2 = stft_l2_distance(
                obs["mixed_bin_audio_mag"], pm, obs["gt_bin_comps"],
                mem, obs["gt_mono_comps"],
            )

            if compute_waveform_metrics:
                gm = obs["gt_mono_comps"]
                mix_lin = torch.expm1(obs["mixed_bin_audio_mag"])
                phase = rendered.mixed_bin_audio_phase
                # the step's five ISTFTs as one batch: one irfft, one overlap_add
                gt_sig, mono_sig, mem_sig, mix_l, mix_r = istft_mag_phase(
                    torch.stack((gm[..., 0], mono[..., 0], mem[..., 0],
                                 mix_lin[..., 0], mix_lin[..., 1])),
                    torch.stack((gm[..., 1], gm[..., 1], gm[..., 1],
                                 phase[..., 0], phase[..., 1])),
                )
                mix_sig = 0.5 * (
                    (mix_l - mix_l.mean(-1, keepdim=True))
                    + (mix_r - mix_r.mean(-1, keepdim=True))
                )
                si_mono = _si_metrics(gt_sig, mono_sig, mix_sig)
                si_mem = _si_metrics(gt_sig, mem_sig, mix_sig)
            else:
                si_mono = si_mem = torch.zeros((n, len(SI_METRIC_NAMES)), device=device)

            env_state, info = de.env_step(
                dev.scene, dev.episodes, env_state, codes[act.action[:, 0]],
                max_episode_steps,
            )
            masks = 1.0 - info["done"].to(torch.float32)[:, None]
            prev_mem = mem * masks[:, :, None, None]
            steps.append({
                "bin_l2": bin_l2[:, 0], "mono_l2": mono_l2[:, 0],
                "mem_l2": mem_l2[:, 0], "si_mono": si_mono, "si_mem": si_mem,
                "geo": info["geo"], "ndg": info["ndg"], "action": act.action[:, 0],
            })

        outs = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        per_env = {
            "mono_l2_last": outs["mono_l2"][-1],
            "mono_l2_all": outs["mono_l2"].mean(0),
            "mem_l2_last": outs["mem_l2"][-1],
            "mem_l2_all": outs["mem_l2"].mean(0),
            "bin_l2_all": outs["bin_l2"].mean(0),
            "geo_last": outs["geo"][-1],
            "ndg_last": outs["ndg"][-1],
            "si_mono_last": outs["si_mono"][-1],
            "si_mem_last": outs["si_mem"][-1],
        }
        return env_state, per_env, outs

    return eval_episodes


def _policy(cfg, state_dict, num_actions: int, device,
            dtype: torch.dtype = torch.float32) -> Move2HearPolicy:
    """The policy of `cfg` in compute dtype `dtype`, loading `state_dict`
    strictly (a reference checkpoint that was not converted raises, naming
    the import script)."""
    refuse_reference_layout(state_dict, "the evaluated checkpoint")
    p = cfg.RL.PPO
    policy = Move2HearPolicy(
        num_actions=num_actions, hidden_size=p.hidden_size,
        extra_rgb=cfg.EXTRA_RGB, extra_depth=cfg.EXTRA_DEPTH, use_ddppo=p.use_ddppo,
        dtype=dtype,
    )
    policy.load_state_dict(state_dict)
    return policy.to(device).eval()


def eval_policies(cfg, ckpt: dict, num_actions: int, device,
                  dtype: torch.dtype = torch.float32):
    """(navigation policy, quality-improvement policy) of a loaded
    checkpoint, in compute dtype `dtype`: the two policies of a switch
    checkpoint under RL.PPO.switch_policy, else its one policy twice."""
    if not cfg.RL.PPO.switch_policy:
        policy = _policy(cfg, ckpt["state_dict"], num_actions, device, dtype)
        return policy, policy
    if "state_dict_nav" not in ckpt or "state_dict_qualImprov" not in ckpt:
        raise KeyError(
            f"RL.PPO.switch_policy needs a switch checkpoint, not one holding "
            f"{sorted(ckpt)}: merge one with scripts/torch_merge_switch_ckpt.py "
            "NAV_CKPT QUALIMPROV_CKPT OUT_CKPT"
        )
    return (_policy(cfg, ckpt["state_dict_nav"], num_actions, device, dtype),
            _policy(cfg, ckpt["state_dict_qualImprov"], num_actions, device, dtype))


def default_eval_bundle(cfg):
    """The synthetic micro-scene an evaluation runs on when no bundle is
    given: near-target or far-target episodes as the config trains, the
    disjoint procedural sound pool for the unheard splits."""
    p = cfg.RL.PPO
    return build_micro_scene(
        rows=4, cols=4, num_episodes=64,
        near_target=not p.switch_policy and p.sep_reward_weight == 1.0,
        rir_length=cfg.TPU.MAX_RIR_LENGTH,
        unheard_sounds="unheard" in cfg.TASK_CONFIG.DATASET.SPLIT.lower(),
    )


def eval_episodes_of(cfg, bundle):
    """The bundle's episodes under the eval filters EPS_SCENES and
    EPS_SCENES_N_IDS (env_utils.py:683-685, dataset.py:134-160)."""
    episodes = bundle.episodes
    if cfg.EPS_SCENES:
        episodes = episodes.filter_by_scenes(cfg.EPS_SCENES)
    if cfg.EPS_SCENES_N_IDS:
        episodes = episodes.filter_by_scenes_n_ids(dict(cfg.EPS_SCENES_N_IDS))
    return episodes


def write_eval_outputs(cfg, checkpoint_index: int, stats_episodes: dict,
                       eval_metrics_dump: dict) -> Dict:
    """The aggregates (mean and std of each scalar per-episode measure) of an
    evaluation, written as ``{split}_stats_ckpt_{i}_{seed}.json`` with the
    per-episode, per-step metrics as ``eval_metrics_ckpt_{i}.pkl`` under
    MODEL_DIR (ppo_trainer.py:1484-1518). Returns the aggregates."""
    agg = {}
    for k in next(iter(stats_episodes.values())):
        vals = [v[k] for v in stats_episodes.values() if np.isscalar(v[k])]
        if vals:
            agg[k] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
    out_dir = cfg.MODEL_DIR or "."
    os.makedirs(out_dir, exist_ok=True)
    stats_path = os.path.join(
        out_dir, f"{cfg.EVAL.SPLIT}_stats_ckpt_{checkpoint_index}_{cfg.SEED}.json"
    )
    with open(stats_path, "w") as f:
        json.dump(agg, f, indent=2)
    with open(os.path.join(out_dir, f"eval_metrics_ckpt_{checkpoint_index}.pkl"), "wb") as f:
        pickle.dump({str(k): v for k, v in eval_metrics_dump.items()}, f)
    return agg


class DeviceEvalSetup(NamedTuple):
    eval_fn: Callable
    dev: de.DeviceBundle
    bundle: object
    episodes: object
    n_episodes: int
    n_envs: int
    max_steps: int
    generator: torch.Generator


def setup_device_eval(
    cfg, ckpt: dict, bundle=None, episode_count: Optional[int] = None,
    batch_envs: int = 16, device="cuda",
) -> DeviceEvalSetup:
    """Everything the episode loop needs, from the config and a loaded
    checkpoint: the policies, the (default micro-scene) bundle on the
    device, the filtered and clamped episode set and the seeded generator."""
    device = torch.device(device)
    p = cfg.RL.PPO
    switch = p.switch_policy
    action_codes = tuple(int(Action[a]) for a in cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)
    # float32 whatever TPU.COMPUTE_DTYPE says, as the JAX package's device
    # evaluator (move2hear_tpu/eval/device_evaluator.py builds its policy
    # without a dtype)
    policy_nav, policy_qi = eval_policies(cfg, ckpt, len(action_codes), device)
    logger.info("device evaluator: float32 compute (TPU.COMPUTE_DTYPE %s)",
                cfg.TPU.get("COMPUTE_DTYPE", "float32"))
    if bundle is None:
        bundle = default_eval_bundle(cfg)
    # the count clamp of ppo_trainer.py:1058-1078
    episodes = eval_episodes_of(cfg, bundle)
    n_episodes = min(episode_count or cfg.get("EVAL_EPISODE_COUNT", 1000), len(episodes))
    max_steps = cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS

    dev = de.build_device_bundle(
        bundle, device, episodes=episodes,
        precompute_rir_rfft=bool(cfg.TPU.PRECOMPUTE_RIR_RFFT),
    )
    eval_fn = make_device_eval(
        policy_nav, policy_qi, max_steps,
        cfg.TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM, action_codes,
        bool(p.deterministic_eval), switch_policy=switch,
        time_thres=p.time_thres_for_pol_switch,
        compute_waveform_metrics=cfg.COMPUTE_EVAL_METRICS,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(int(cfg.SEED))
    return DeviceEvalSetup(eval_fn, dev, bundle, episodes, n_episodes,
                           min(batch_envs, n_episodes), max_steps, generator)


def evaluate_checkpoint_device(
    config,
    checkpoint_path: str,
    checkpoint_index: int = 0,
    bundle=None,
    episode_count: Optional[int] = None,
    batch_envs: int = 16,
    device="cuda",
    timings: Optional[dict] = None,
    actions_out: Optional[dict] = None,
) -> Dict:
    """Batched device evaluation: episodes go round-robin to `batch_envs`
    parallel envs; each call of the eval function plays one full horizon
    for the whole batch. Writes ``{split}_stats_ckpt_{i}_{seed}.json`` and
    ``eval_metrics_ckpt_{i}.pkl`` under MODEL_DIR in the JAX package's
    layout and returns the aggregates. `timings`, if given, receives the
    set-up and episode-loop seconds and the episode and env-step counts;
    `actions_out`, if given, each episode's actions by (scene, episode id)."""
    t_setup = time.perf_counter()
    device = torch.device(device)
    cfg = config
    setup = setup_device_eval(cfg, load_checkpoint(checkpoint_path), bundle,
                              episode_count, batch_envs, device)
    eval_fn, dev, episodes, generator = setup.eval_fn, setup.dev, setup.episodes, setup.generator
    n_episodes, n_envs, max_steps = setup.n_episodes, setup.n_envs, setup.max_steps
    si_names = (
        [m for m in cfg.EVAL_METRICS_TO_COMPUTE if m in SI_METRIC_NAMES]
        if cfg.COMPUTE_EVAL_METRICS else []
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_loop = time.perf_counter()

    stats_episodes, eval_metrics_dump = {}, {}
    done_eps = batch_idx = 0
    while done_eps < n_episodes:
        # batch b covers episodes [b*n_envs, (b+1)*n_envs), round-robin
        idxs = [(batch_idx * n_envs + i) % len(episodes) for i in range(n_envs)]
        order = torch.tensor(idxs, dtype=torch.long, device=device)[:, None]
        env_state = de.env_reset_all(dev.scene, dev.episodes, order)
        with torch.inference_mode():
            _, per_env, outs = eval_fn(dev, env_state, generator)
        per_env = {k: v.cpu().numpy() for k, v in per_env.items()}
        outs_h = {
            k: outs[k].cpu().numpy()
            for k in ("mono_l2", "mem_l2", "bin_l2", "si_mono", "si_mem", "action")
        }
        # slots past the count clamp repeat earlier episodes (round-robin
        # padding) and are dropped from both dumps
        take = min(n_envs, n_episodes - done_eps)
        for i in range(take):
            ep = episodes.episodes[idxs[i]]
            entry = {
                k: float(per_env[k][i])
                for k in ("mono_l2_last", "mono_l2_all", "mem_l2_last",
                          "mem_l2_all", "bin_l2_all")
            }
            entry["geo_distance_to_target_audio_source"] = float(per_env["geo_last"][i])
            entry["normalized_geo_distance_to_target_audio_source"] = float(
                per_env["ndg_last"][i]
            )
            entry.update(per_goal_distance_columns(setup.bundle.scenes[ep.scene_id], ep))
            if cfg.COMPUTE_EVAL_METRICS:
                for j, name in enumerate(SI_METRIC_NAMES):
                    entry[f"mono_{name}_last"] = float(per_env["si_mono_last"][i, j])
                    entry[f"monoFromMem_{name}_last"] = float(per_env["si_mem_last"][i, j])
            stats_episodes[(ep.scene_id, ep.episode_id)] = entry

            # per-episode, per-step dump in the host evaluator's layout
            # (ppo_trainer.py:1386-1431,1506-1518)
            ep_metrics = {
                "mono_l2": [float(x) for x in outs_h["mono_l2"][:, i]],
                "mem_l2": [float(x) for x in outs_h["mem_l2"][:, i]],
                "bin_l2": [float(x) for x in outs_h["bin_l2"][:, i]],
                "quality": [],
            }
            for t in range(outs_h["si_mono"].shape[0] if si_names else 0):
                q = {"mono": {}, "monoFromMem": {}}
                for m in si_names:
                    j = SI_METRIC_NAMES.index(m)
                    q["mono"][m] = float(outs_h["si_mono"][t, i, j])
                    q["monoFromMem"][m] = float(outs_h["si_mem"][t, i, j])
                ep_metrics["quality"].append(q)
            eval_metrics_dump[(ep.scene_id, ep.episode_id)] = ep_metrics
            if actions_out is not None:
                actions_out[(ep.scene_id, ep.episode_id)] = [int(a) for a in outs_h["action"][:, i]]
        done_eps += take
        batch_idx += 1
    t_end = time.perf_counter()

    agg = write_eval_outputs(cfg, checkpoint_index, stats_episodes, eval_metrics_dump)
    if timings is not None:
        timings.update(
            setup_s=t_loop - t_setup, loop_s=t_end - t_loop,
            episodes=n_episodes, env_steps=batch_idx * n_envs * max_steps,
        )
    return agg

"""On-device rollout collection and the cached separator refit (the JAX
package's ``rl/device_rollout.py``, separate-programs route). The collect
gathers its RIRs from the dense bank or from the sub-bank slab and table
that ``dev`` holds for the window (``env/device_env.py:gather_sensors``);
the refit reads only what the collect cached, never the RIRs.

One collect runs a T-step rollout as a Python loop under ``torch.no_grad``:
{render from the banks -> separator chain -> acoustic memory -> policy act
-> device env step}, then one more forward on the final observation for the
last reward's q and the bootstrap value. All tensors stay on the device;
the logging stats come back packed in one (T, N, K) tensor.

Separation rewards (near-target) match the reference (env_utils.py:690-714
applied at ppo_trainer.py:385-405):
  r_t = not_done_t * (q_{t+1} - q_t)            at ordinary steps,
  r_t = not_done_t * 2 * extra_mult * q_{t+1}   at episode step MAX-2,
  q = -MSE(memPred, gt_mono) / mean(gt_mono^2).
The bonus-step form reproduces the reference's list aliasing: the "extra"
override_rewards call MUTATES the same rewards list it returns, so
``np.array(rewards) + np.array(rewards_extra)`` doubles extra_mult*q_next
and the quality-improvement delta is discarded (ppo_trainer.py:395-405).
Navigation rewards (far-target) are the env's decrease of the geodesic
distance to the target, times ``nav_reward_scale``.

The separator refit trains only the acoustic memory, on the frozen
separators' outputs that the collect cached (``pred_mono``, ``gt_mono``,
``prev_mem``): no re-render and no U-Net forward.
"""

from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

import move2hear_tpu_torch.env.device_env as de
from move2hear_tpu_torch.eval.metrics import stft_l2_distance
from move2hear_tpu_torch.models.distributions import Categorical
from move2hear_tpu_torch.models.policy import Move2HearPolicy
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture_pre
from move2hear_tpu_torch.ops.spec import slice16_nchw
from move2hear_tpu_torch.parallel.dist import all_reduce_, world
from move2hear_tpu_torch.rl.gae import compute_returns
from move2hear_tpu_torch.rl.ppo import AgentState, PPOConfig, _epoch_perms, _rank_members


@dataclass
class RolloutSepIdx:
    """(T_sep, N, ...) separator-refit buffer: the bank indices of every
    step and the frozen-separator outputs the memory refit consumes.
    ``bin_l1`` / ``mono_l1`` are the per-step logging losses. The three
    spectrogram slabs are stored in `slab_dtype` (``TPU.SEP_SLAB_DTYPE``:
    bfloat16 halves their bytes; a write rounds to it, the refit widens
    them back to float32 once)."""

    sound_ids: torch.Tensor     # (T, N, S)
    az_idx: torch.Tensor        # (T, N)
    scene_idx: torch.Tensor     # (T, N)
    node: torch.Tensor          # (T, N)
    sources: torch.Tensor       # (T, N, S)
    target_class: torch.Tensor  # (T, N, 1)
    prev_mem: torch.Tensor      # (T, N, F, Tt, 1) memory entering the step
    masks: torch.Tensor         # (T, N, 1) not-done mask entering the step
    pred_mono: torch.Tensor     # (T, N, F, Tt, 1) frozen bin2mono output
    gt_mono: torch.Tensor       # (T, N, F, Tt, 1) GT mono magnitude
    bin_l1: torch.Tensor        # (T, N)
    mono_l1: torch.Tensor       # (T, N)

    @classmethod
    def create(cls, t_total, n, s, f=512, tt=32, device=None, slab_dtype=torch.float32):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        i64 = torch.long
        return cls(
            sound_ids=z(t_total, n, s, dtype=i64), az_idx=z(t_total, n, dtype=i64),
            scene_idx=z(t_total, n, dtype=i64), node=z(t_total, n, dtype=i64),
            sources=z(t_total, n, s, dtype=i64), target_class=z(t_total, n, 1, dtype=i64),
            prev_mem=z(t_total, n, f, tt, 1, dtype=slab_dtype),
            masks=torch.ones((t_total, n, 1), device=device),
            pred_mono=z(t_total, n, f, tt, 1, dtype=slab_dtype),
            gt_mono=z(t_total, n, f, tt, 1, dtype=slab_dtype),
            bin_l1=z(t_total, n), mono_l1=z(t_total, n),
        )


def write_sep_slab(buf: RolloutSepIdx, slab: Dict[str, torch.Tensor], offset: int) -> RolloutSepIdx:
    """Copy a rollout's (T, ...) slab into rows [offset, offset + T) of the
    buffer, in place, cast to the buffer's dtypes."""
    for f in fields(buf):
        dst = getattr(buf, f.name)
        src = slab[f.name]
        dst[offset : offset + src.shape[0]].copy_(src)
    return buf


# packed stats layout (last axis): q, bin_l2, mono_l2, mem_l2, done, geo,
# ndg, reward, then the action-probability vector
STAT_FIELDS = ("q", "bin_l2", "mono_l2", "mem_l2", "done", "geo", "ndg", "reward")


def unpack_stats(packed) -> Dict[str, Any]:
    """(..., N, K) packed stats -> dict of (..., N) arrays + 'probs'."""
    out = {name: packed[..., i] for i, name in enumerate(STAT_FIELDS)}
    out["probs"] = packed[..., len(STAT_FIELDS):]
    return out


def sep_reward(q_now, q_next, not_done, at_bonus, extra_reward_multiplier):
    """Effective per-step separation reward (module docstring):

      r = not_done * (q_next - q_now)                 ordinary steps
      r = not_done * 2 * extra_mult * q_next          at episode step MAX-2
    """
    bonus = torch.as_tensor(at_bonus).to(torch.float32)
    return not_done * (
        (1.0 - bonus) * (q_next - q_now) + bonus * 2.0 * extra_reward_multiplier * q_next
    )


class CollectOutput(NamedTuple):
    env_state: de.DeviceEnvState
    hidden: torch.Tensor
    masks: torch.Tensor            # (N, 1) entering the next step
    prev_mem_masked: torch.Tensor  # (N, F, T, 1)
    rollouts_pol: Dict[str, Any]   # ready for make_update_pol
    sep_slab: Dict[str, Any]       # (T, ...) rows for the sep buffer
    stats: torch.Tensor            # (T, N, K) packed logging stats


def _forward(policy: Move2HearPolicy, obs, prev_mem_masked):
    pred_masks = policy.get_binSepMasks(obs)
    pred_mono = policy.convert_bin2mono(pred_masks, obs["mixed_bin_audio_mag"])
    return pred_masks, pred_mono, policy.get_monoFromMem(pred_mono, prev_mem_masked)


def _obs_from_sensors(sensors, gt_norm):
    """Observations from the gathered sensors. Magnitudes only: the collect
    reads phases only through stft_l2_distance, whose same-phase form does
    not depend on them."""
    rendered = render_binaural_mixture_pre(
        sensors["mono_rfft"], sensors.get("rirs"), sensors["gt_mono_raw"],
        sensors["mono_len"], gt_mono_mag_norm=gt_norm,
        rir_rfft=sensors.get("rir_rfft"), rir_len=sensors.get("rir_len", 0),
        mags_only=True,
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
    return obs


def q_util(pred_mem, gt_mono_mag):
    """The separation-quality utility q = -MSE / mean(gt^2), per env."""
    mse = torch.mean(torch.square(pred_mem - gt_mono_mag), dim=(1, 2, 3))
    pw = torch.mean(torch.square(gt_mono_mag), dim=(1, 2, 3))
    return -mse / torch.clamp(pw, min=1e-12)


def make_collect(
    policy: Move2HearPolicy,
    cfg: PPOConfig,
    t_steps: int,
    max_episode_steps: int,
    gt_mono_mag_norm: float,
    extra_reward_multiplier: float,
    action_codes: Tuple[int, ...],
    pol_sensors: Tuple[str, ...],
    pose_obs: bool = False,
    sampler: Optional[Callable[[Categorical, int], torch.Tensor]] = None,
    sep_rewards: bool = True,
    nav_reward_scale: float = 0.0,
    sample_rows: Optional[Tuple[int, int]] = None,
):
    """The rollout collector:
    ``collect(dev, env_state, hidden, masks, prev_mem_masked, generator)``
    -> CollectOutput.

    sep_rewards: separation rewards (near-target); when false, navigation
    rewards ``nav_reward * nav_reward_scale`` (far-target). The separator
    outputs, ``q`` and the sep slab are the same in both: the refit runs in
    both tasks.

    `sampler(dist, t)` draws the (N, 1) actions of step t; by default
    ``dist.sample(generator, sample_rows)``, `sample_rows` (start, total)
    naming this rank's envs among the world's (``models/distributions.py``).
    A test passes one that replays the actions of another run.

    pose_obs: store an integer ``pose`` index in the rollout observations in
    place of the rgb/depth frames (needs the per-rollout visual-feature bank;
    the trainer passes the matching ``pose_bank`` flag to make_update_pol)."""

    @torch.no_grad()
    def collect(dev: de.DeviceBundle, env_state: de.DeviceEnvState, hidden, masks,
                prev_mem_masked, generator: Optional[torch.Generator] = None) -> CollectOutput:
        codes = torch.as_tensor(action_codes, dtype=torch.long, device=hidden.device)
        hidden0 = hidden

        # per-rollout visual-feature bank: the parameters do not change
        # within the rollout, so the visual conv stack runs once over the
        # S*V*4 distinct poses when they are no more than the N*T steps (or
        # the update reads poses: a segment of a rollout split by the
        # preemptive sync has fewer steps)
        vis_bank = None
        frame_bank = dev.rgb_bank if dev.rgb_bank is not None else dev.depth_bank
        if frame_bank is not None and policy.pol_net.visual_encoder is not None:
            s, v = frame_bank.shape[0], frame_bank.shape[1]
            if pose_obs or s * v * 4 <= masks.shape[0] * t_steps:
                def flat(b):
                    return None if b is None else b.reshape((-1,) + tuple(b.shape[3:]))

                vis_bank = policy.visual_features(flat(dev.rgb_bank), flat(dev.depth_bank))
        if pose_obs and vis_bank is None:
            raise ValueError(
                "make_collect(pose_obs=True) requires the per-rollout "
                "visual-feature bank (a frame bank with S*V*4 <= N*T)"
            )

        def pose_of(obs_idx):
            return (obs_idx.scene_idx * frame_bank.shape[1] + obs_idx.node) * 4 + obs_idx.rot_idx

        def with_vis(obs, obs_idx):
            if vis_bank is None:
                return obs
            return {**obs, "visual_feats": vis_bank[pose_of(obs_idx)]}

        steps = []
        for t in range(t_steps):
            obs_idx = de.observe(dev.episodes, env_state)
            obs = _obs_from_sensors(de.gather_sensors(dev, obs_idx), gt_mono_mag_norm)
            pred_masks, pred_mono, pred_mem = _forward(policy, obs, prev_mem_masked)
            act = policy.act(
                with_vis(obs, obs_idx), hidden, masks, pred_masks, pred_mono, pred_mem,
                generator=generator, rows=sample_rows,
                sampler=None if sampler is None else (lambda d, t=t: sampler(d, t)),
            )
            gt_mono_mag = obs["gt_mono_comps"][..., 0::2][..., :1]
            # per-step logging L1 losses of the refit: the separators are
            # frozen, so they are computed once, here
            gt_bin_mag = obs["gt_bin_comps"][..., 0::2][..., :2]
            bin_l1 = torch.abs(
                torch.expm1(obs["mixed_bin_audio_mag"]) * pred_masks - gt_bin_mag
            ).mean(dim=(1, 2, 3))
            mono_l1 = torch.abs(pred_mono - gt_mono_mag).mean(dim=(1, 2, 3))
            bin_l2, mono_l2 = stft_l2_distance(
                obs["mixed_bin_audio_mag"], pred_masks, obs["gt_bin_comps"],
                pred_mono, obs["gt_mono_comps"],
            )
            _, mem_l2 = stft_l2_distance(
                obs["mixed_bin_audio_mag"], pred_masks, obs["gt_bin_comps"],
                pred_mem, obs["gt_mono_comps"],
            )
            # bonus flag BEFORE stepping: completed steps == MAX-2
            # (ppo_trainer.py:395)
            at_bonus = env_state.step_count == max_episode_steps - 2
            env_state, info = de.env_step(
                dev.scene, dev.episodes, env_state, codes[act.action[:, 0]], max_episode_steps,
            )
            masks_next = 1.0 - info["done"].to(torch.float32)[:, None]
            stored_obs = {k: obs[k] for k in pol_sensors if not (pose_obs and k in ("rgb", "depth"))}
            if pose_obs:
                stored_obs["pose"] = pose_of(obs_idx)
            steps.append({
                "obs": stored_obs, "pred_masks": pred_masks, "pred_mono": pred_mono,
                "pred_mem": pred_mem, "value": act.value, "action": act.action,
                "log_prob": act.action_log_probs, "hidden": act.hidden,
                "masks_in": masks, "masks_next": masks_next, "prev_mem_in": prev_mem_masked,
                "q": q_util(pred_mem, gt_mono_mag), "bin_l2": bin_l2, "mono_l2": mono_l2,
                "mem_l2": mem_l2, "at_bonus": at_bonus, "done": info["done"],
                "nav_reward": info["nav_reward"],
                "geo": info["geo"], "ndg": info["ndg"], "probs": act.probs,
                "sound_ids": obs_idx.sound_ids, "az_idx": obs_idx.azimuth_idx,
                "scene_idx": obs_idx.scene_idx, "node": obs_idx.node,
                "sources": obs_idx.sources, "target_class": obs_idx.target_class,
                "gt_mono": gt_mono_mag, "bin_l1": bin_l1, "mono_l1": mono_l1,
            })
            hidden, masks = act.hidden, masks_next
            prev_mem_masked = pred_mem * masks_next[:, :, None, None]

        def stacked(key):
            return torch.stack([s[key] for s in steps])

        # final forward on obs_T: bootstrap value and q_T of the last reward
        obs_idx_t = de.observe(dev.episodes, env_state)
        obs_t = _obs_from_sensors(de.gather_sensors(dev, obs_idx_t), gt_mono_mag_norm)
        pm_t, mono_t, mem_t = _forward(policy, obs_t, prev_mem_masked)
        value_t = policy.get_value(
            with_vis(obs_t, obs_idx_t), hidden, masks, pm_t, mono_t, mem_t
        )
        q_t = q_util(mem_t, obs_t["gt_mono_comps"][..., 0::2][..., :1])

        # rewards from the one-step-ahead q: a (T+1, N) series
        q = stacked("q")
        q_full = torch.cat([q, q_t[None]], dim=0)
        done = stacked("done").to(torch.float32)
        if sep_rewards:
            rewards = sep_reward(
                q_full[:-1], q_full[1:], 1.0 - done, stacked("at_bonus"), extra_reward_multiplier,
            )
        else:
            rewards = stacked("nav_reward") * nav_reward_scale
        rewards = rewards[:, :, None]  # (T, N, 1)

        # the (T+1)-slot views make_update_pol reads
        masks_full = torch.cat([steps[0]["masks_in"][None], stacked("masks_next")], dim=0)
        value_preds = torch.cat([stacked("value"), value_t[None]], dim=0)
        returns = compute_returns(rewards, value_preds, masks_full, cfg.gamma, cfg.tau, cfg.use_gae)
        observations = {}
        for k in steps[0]["obs"]:
            v = torch.stack([s["obs"][k] for s in steps])
            observations[k] = torch.cat([v, v[-1:]], dim=0)
        pred_mem = stacked("pred_mem")
        rollouts_pol = {
            "observations": observations,
            "hidden": torch.cat([hidden0[None], stacked("hidden")], dim=0),
            "pred_binSepMasks": stacked("pred_masks"),
            "pred_mono": stacked("pred_mono"),
            "prev_pred_monoFromMem": torch.cat([steps[0]["prev_mem_in"][None], pred_mem], dim=0),
            "rewards": rewards,
            "value_preds": value_preds,
            "returns": returns,
            "action_log_probs": stacked("log_prob"),
            "actions": stacked("action"),
            "masks": masks_full,
        }
        sep_slab = {
            k: stacked(k) for k in (
                "sound_ids", "az_idx", "scene_idx", "node", "sources", "target_class",
                "pred_mono", "gt_mono", "bin_l1", "mono_l1",
            )
        }
        sep_slab["prev_mem"] = stacked("prev_mem_in")
        sep_slab["masks"] = stacked("masks_in")
        # all logging stats in ONE (T, N, K) tensor: one host fetch
        stats = torch.cat([
            q[..., None], stacked("bin_l2"), stacked("mono_l2"), stacked("mem_l2"),
            done[..., None], stacked("geo")[..., None], stacked("ndg")[..., None],
            rewards, stacked("probs"),
        ], dim=-1)
        return CollectOutput(env_state, hidden, masks, prev_mem_masked, rollouts_pol,
                             sep_slab, stats)

    return collect


def _mem_refit(policy: Move2HearPolicy, cfg: PPOConfig, n_updates: int, state: AgentState,
               mono_s, gt_s, prev_s, masks, generator, lr_scales, w_rows=None, wsum=None,
               refit_dtype: Optional[torch.dtype] = None):
    """The refit's grad steps: n_updates x ppo_epoch x num_mini_batch L1
    steps of the acoustic memory on its sliced inputs (T, N, 16, F/16, Tt),
    its convolutions in `refit_dtype` (None: the policy's compute dtype)
    and the loss in float32. The masking of the carried memory and the
    channel concat are done once, outside the loop. Returns the
    (n_updates,) mean memory losses.

    `w_rows` ((T, 1) row weights, `wsum` their sum) makes each loss the
    rank's share of the global weighted mean, summed over the world with
    the gradients (``rl/ppo.py:make_update_pol``); None keeps the plain
    mean of a world of one."""
    rank, size = world()
    t, n = masks.shape[0], masks.shape[1]
    x_cat = torch.cat([mono_s, prev_s * masks.reshape(t, n, 1, 1, 1)], dim=2)
    steps_per_update = cfg.ppo_epoch * cfg.num_mini_batch
    full_batch = cfg.num_mini_batch == 1
    shares = w_rows is not None
    if shares:
        w_full = w_rows.expand(t, n)
        count = max(wsum * (n * size // cfg.num_mini_batch), 1.0)

    def flat(v):
        return v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))

    x_full, g_full = flat(x_cat), flat(gt_s)
    losses = []
    for u in range(n_updates):
        lr = cfg.lr_sep * float(lr_scales[u])
        if full_batch:
            batches = [(x_full, g_full, flat(w_full) if shares else None)] * steps_per_update
        else:
            perms = _epoch_perms(generator, cfg.ppo_epoch, n * size, cfg.num_mini_batch,
                                 device=x_cat.device)
            members = [_rank_members(idx, rank, n, size) for idx in perms]
            batches = [(flat(x_cat[:, idx]), flat(gt_s[:, idx]),
                        flat(w_full[:, idx]) if shares else None) for idx in members]
        for x, g, w in batches:
            state.opt_sep.zero_grad()
            if x.shape[0] == 0:
                loss = torch.zeros((), device=x.device)
            else:
                err = torch.abs(policy.acoustic_mem(x, sliced=True, dtype=refit_dtype) - g)
                loss = (err.mean(dim=(1, 2, 3)) * w).sum() / count if shares else err.mean()
                loss.backward()
            losses.append(state.opt_sep.step(lr, extra=loss.detach().reshape(1))[0])
    return torch.stack(losses).reshape(n_updates, steps_per_update).mean(dim=1)


def make_update_sep_from_slabs(policy: Move2HearPolicy, cfg: PPOConfig, n_updates: int,
                               with_validity: bool = False,
                               refit_dtype: Optional[torch.dtype] = None):
    """All `n_updates` separator refits of a cycle:
    ``update(state, buf, generator, lr_scales, fill=None)`` -> (n_updates, 3)
    losses (bin L1, mono L1, memory L1 per update). It trains the acoustic
    memory on the frozen-separator outputs the collect cached in the buffer,
    the same values the reference recomputes every minibatch
    (ppo.py:179-246): the passive separators are frozen and their BatchNorm
    uses running statistics.

    With `with_validity` only the first `fill` rows of the buffer (those the
    cycle's rollouts, cut by the preemptive sync, wrote) weigh in the losses
    and the logged means. In a world of ranks the losses are shares of the
    global means, summed over the world with the gradients. `refit_dtype`
    (``TPU.SEP_REFIT_DTYPE``) is the memory's compute dtype in the refit;
    None keeps the policy's. bfloat16 slabs are widened to float32 once,
    before the loop."""
    size = world()[1]
    shares = size > 1 or with_validity

    def update(state: AgentState, buf: RolloutSepIdx, generator, lr_scales, fill=None):
        def sliced(v):  # (T, N, F, Tt, 1) -> (T, N, 16, F/16, Tt)
            if v.dtype == torch.bfloat16:
                v = v.float()
            t, n = v.shape[0], v.shape[1]
            s = slice16_nchw(v.reshape((t * n,) + tuple(v.shape[2:])))
            return s.reshape((t, n) + tuple(s.shape[1:]))

        t_rows, n = buf.masks.shape[0], buf.masks.shape[1]
        w_rows = wsum = None
        if shares:
            wsum = float(t_rows if fill is None else fill)
            w_rows = (torch.arange(t_rows, device=buf.masks.device) < wsum).to(
                torch.float32).reshape(t_rows, 1)
        mem_losses = _mem_refit(
            policy, cfg, n_updates, state, sliced(buf.pred_mono), sliced(buf.gt_mono),
            sliced(buf.prev_mem), buf.masks, generator, lr_scales, w_rows, wsum,
            refit_dtype=refit_dtype,
        )
        if shares:
            count = max(wsum * n * size, 1.0)
            logged = all_reduce_(torch.stack([(buf.bin_l1 * w_rows).sum() / count,
                                              (buf.mono_l1 * w_rows).sum() / count]))
            bin_loss, mono_loss = logged[0], logged[1]
        else:
            bin_loss, mono_loss = buf.bin_l1.mean(), buf.mono_l1.mean()
        per_update = torch.stack([
            bin_loss.expand(n_updates), mono_loss.expand(n_updates), mem_losses,
        ], dim=1)
        return per_update

    return update


def concat_collect_outputs(prefix: CollectOutput, tail: CollectOutput,
                           cfg: PPOConfig) -> CollectOutput:
    """Join the two segments of a rollout that the DDPPO preemptive sync
    split (a prefix of ceil(short_rollout_threshold * T) steps, one store
    check, then the tail) into one full-length rollout, with the returns
    computed anew over the joined horizon (the JAX package's
    ``concat_collect_outputs``). The boundary is exact: the prefix's final
    forward and the tail's first step see the same observation and
    parameters, so the prefix's last reward and the tail's first value are
    those one unsplit collect computes."""
    def cat(a, b):
        return torch.cat([a, b], dim=0)

    p, t = prefix.rollouts_pol, tail.rollouts_pol
    rewards = cat(p["rewards"], t["rewards"])
    value_preds = cat(p["value_preds"][:-1], t["value_preds"])
    masks = cat(p["masks"][:-1], t["masks"])
    rollouts_pol = {
        "observations": {k: cat(p["observations"][k][:-1], t["observations"][k])
                         for k in p["observations"]},
        "hidden": cat(p["hidden"], t["hidden"][1:]),
        "pred_binSepMasks": cat(p["pred_binSepMasks"], t["pred_binSepMasks"]),
        "pred_mono": cat(p["pred_mono"], t["pred_mono"]),
        "prev_pred_monoFromMem": cat(p["prev_pred_monoFromMem"],
                                     t["prev_pred_monoFromMem"][1:]),
        "rewards": rewards,
        "value_preds": value_preds,
        "returns": compute_returns(rewards, value_preds, masks, cfg.gamma, cfg.tau,
                                   cfg.use_gae),
        "action_log_probs": cat(p["action_log_probs"], t["action_log_probs"]),
        "actions": cat(p["actions"], t["actions"]),
        "masks": masks,
    }
    return CollectOutput(
        tail.env_state, tail.hidden, tail.masks, tail.prev_mem_masked, rollouts_pol,
        {k: cat(prefix.sep_slab[k], tail.sep_slab[k]) for k in prefix.sep_slab},
        cat(prefix.stats, tail.stats),
    )

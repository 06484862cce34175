"""Rollout storage of the host env path (``common/rollout_storage.py``; the
JAX package's ``rl/rollout.py``) as plain tensor containers on the device,
written in place:

  - RolloutPol: T = num_steps, everything the PPO update reads
    (observations, GRU hidden, separator predictions, rewards, values,
    returns, log-probs, actions, masks) [rollout_storage.py:6-312]
  - RolloutSep: T = num_steps * num_updates_per_cycle, the render keys
    (sound ids, RIRs, target class) of every step with the carried memory
    and masks; the separator refit renders the spectrograms anew from the
    keys (rl/ppo.py:make_update_sep) [rollout_storage.py:315-471]

``insert_*`` writes step `step`'s outputs and the NEXT step's inputs
(slot step + 1); ``after_update_*`` rolls slot `last` (T unless given) into
slot 0 (rollout_storage.py:150-157). ``as_dict`` gives the layout that
``make_update_pol`` and ``make_update_sep`` read.
"""

from dataclasses import dataclass, fields
from typing import Dict, Optional

import torch


def _as_dict(buf) -> dict:
    return {f.name: getattr(buf, f.name) for f in fields(buf)}


@dataclass
class RolloutPol:
    observations: Dict[str, torch.Tensor]   # each (T+1, N, ...)
    hidden: torch.Tensor                    # (T+1, N, H)
    pred_binSepMasks: torch.Tensor          # (T, N, F, Tt, 2)
    pred_mono: torch.Tensor                 # (T, N, F, Tt, 1)
    prev_pred_monoFromMem: torch.Tensor     # (T+1, N, F, Tt, 1)
    rewards: torch.Tensor                   # (T, N, 1)
    value_preds: torch.Tensor               # (T+1, N, 1)
    returns: torch.Tensor                   # (T+1, N, 1)
    action_log_probs: torch.Tensor          # (T, N, 1)
    actions: torch.Tensor                   # (T, N, 1) int64
    masks: torch.Tensor                     # (T+1, N, 1)

    as_dict = _as_dict


@dataclass
class RolloutSep:
    sound_ids: torch.Tensor                 # (T+1, N, S) int64
    rirs: torch.Tensor                      # (T+1, N, S, R, 2)
    target_class: torch.Tensor              # (T+1, N, 1) int64
    prev_pred_monoFromMem: torch.Tensor     # (T+1, N, F, Tt, 1)
    masks: torch.Tensor                     # (T+1, N, 1)

    as_dict = _as_dict


def _obs_buffers(num_steps, num_envs, obs_shapes, device):
    out = {}
    for sensor, shape in obs_shapes.items():
        dt = {"target_class": torch.long, "rgb": torch.uint8}.get(sensor, torch.float32)
        out[sensor] = torch.zeros((num_steps + 1, num_envs) + tuple(shape), dtype=dt,
                                  device=device)
    return out


def create_rollout_pol(num_steps: int, num_envs: int, obs_shapes: Dict[str, tuple],
                       hidden_size: int = 512, spec_shape=(512, 32), device=None) -> RolloutPol:
    f, tt = spec_shape

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return RolloutPol(
        observations=_obs_buffers(num_steps, num_envs, obs_shapes, device),
        hidden=z(num_steps + 1, num_envs, hidden_size),
        pred_binSepMasks=z(num_steps, num_envs, f, tt, 2),
        pred_mono=z(num_steps, num_envs, f, tt, 1),
        prev_pred_monoFromMem=z(num_steps + 1, num_envs, f, tt, 1),
        rewards=z(num_steps, num_envs, 1),
        value_preds=z(num_steps + 1, num_envs, 1),
        returns=z(num_steps + 1, num_envs, 1),
        action_log_probs=z(num_steps, num_envs, 1),
        actions=z(num_steps, num_envs, 1, dtype=torch.long),
        masks=torch.ones((num_steps + 1, num_envs, 1), device=device),
    )


def create_rollout_sep(num_steps: int, num_envs: int, num_sources: int = 2,
                       rir_length: int = 16000, spec_shape=(512, 32), device=None) -> RolloutSep:
    f, tt = spec_shape
    return RolloutSep(
        sound_ids=torch.zeros((num_steps + 1, num_envs, num_sources), dtype=torch.long,
                              device=device),
        rirs=torch.zeros((num_steps + 1, num_envs, num_sources, rir_length, 2), device=device),
        target_class=torch.zeros((num_steps + 1, num_envs, 1), dtype=torch.long, device=device),
        prev_pred_monoFromMem=torch.zeros((num_steps + 1, num_envs, f, tt, 1), device=device),
        masks=torch.ones((num_steps + 1, num_envs, 1), device=device),
    )


def insert_pol(rollouts: RolloutPol, step: int, observations, hidden, actions,
               action_log_probs, values, rewards, masks, pred_binSepMasks, pred_mono,
               pred_monoFromMem) -> RolloutPol:
    """RolloutStoragePol.insert (rollout_storage.py:102-148): the NEXT
    observation, hidden, mask and memory go into slot step + 1; this step's
    predictions, rewards, actions, log-probs and values into slot step."""
    for k, buf in rollouts.observations.items():
        buf[step + 1].copy_(observations[k])
    rollouts.hidden[step + 1].copy_(hidden)
    rollouts.pred_binSepMasks[step].copy_(pred_binSepMasks)
    rollouts.pred_mono[step].copy_(pred_mono)
    rollouts.prev_pred_monoFromMem[step + 1].copy_(pred_monoFromMem)
    rollouts.rewards[step].copy_(rewards)
    rollouts.value_preds[step].copy_(values)
    rollouts.action_log_probs[step].copy_(action_log_probs)
    rollouts.actions[step].copy_(actions)
    rollouts.masks[step + 1].copy_(masks)
    return rollouts


def insert_sep(rollouts: RolloutSep, step: int, sound_ids, rirs, target_class, masks,
               pred_monoFromMem) -> RolloutSep:
    rollouts.sound_ids[step + 1].copy_(sound_ids)
    rollouts.rirs[step + 1].copy_(rirs)
    rollouts.target_class[step + 1].copy_(target_class)
    rollouts.prev_pred_monoFromMem[step + 1].copy_(pred_monoFromMem)
    rollouts.masks[step + 1].copy_(masks)
    return rollouts


def after_update_pol(rollouts: RolloutPol, last: Optional[int] = None) -> RolloutPol:
    """Roll slot `last` (default T) into slot 0."""
    last = -1 if last is None else last
    for buf in rollouts.observations.values():
        buf[0].copy_(buf[last])
    for buf in (rollouts.hidden, rollouts.prev_pred_monoFromMem, rollouts.masks):
        buf[0].copy_(buf[last])
    return rollouts


def after_update_sep(rollouts: RolloutSep, last: Optional[int] = None) -> RolloutSep:
    last = -1 if last is None else last
    for buf in (rollouts.sound_ids, rollouts.rirs, rollouts.target_class,
                rollouts.prev_pred_monoFromMem, rollouts.masks):
        buf[0].copy_(buf[last])
    return rollouts

"""The full Move2Hear policy (the reference's ``rl/ppo/policy.py``).

Submodule names mirror the reference (binSep_enc, binSep_dec, bin2mono_enc,
bin2mono_dec, acoustic_mem, pol_net, action_dist, critic). Spectrogram
inputs and outputs keep the sensor layout (B, F, T, C).

Gradient islands as in the JAX package (its ``stop_gradient``s are
``.detach()`` here): the separator outputs entering the policy net in
``act`` and ``get_value``, the bin2mono input mask and the acoustic-memory
inputs are detached, giving {pol_net, action_dist, critic}, {acoustic_mem}
and the frozen passive separators. ``evaluate_actions`` does not detach:
its inputs are rollout storage.

`dtype` (``TPU.COMPUTE_DTYPE``) is every module's compute dtype, flax's
``dtype=`` (``models/unet.py``): parameters stay float32, the separators'
outputs come in it, the action logits and the value as float32.
"""

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from move2hear_tpu_torch.models.audio_cnn import AudioCNN
from move2hear_tpu_torch.models.distributions import Categorical, CategoricalNet, CriticHead
from move2hear_tpu_torch.models.memory import AcousticMem
from move2hear_tpu_torch.models.rnn import GRUStateEncoder
from move2hear_tpu_torch.models.unet import PassiveSepDecoder, PassiveSepEncoder
from move2hear_tpu_torch.models.visual_cnn import VisualCNN

Observations = Dict[str, torch.Tensor]


class ActOutput(NamedTuple):
    value: torch.Tensor
    action: torch.Tensor
    action_log_probs: torch.Tensor
    hidden: torch.Tensor
    probs: torch.Tensor


class PolicyNet(nn.Module):
    """Visual + bin-audio + mono-audio encoders -> concat -> GRU. A blind
    agent (both EXTRA_RGB and EXTRA_DEPTH) has no visual encoder and a
    2*hidden GRU input."""

    def __init__(self, hidden_size: int = 512, extra_rgb: bool = False,
                 extra_depth: bool = False, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        blind = extra_rgb and extra_depth
        self.visual_encoder = (
            None if blind else VisualCNN(hidden_size, extra_rgb, extra_depth,
                                         generator=generator, dtype=dtype)
        )
        self.bin_encoder = AudioCNN(hidden_size, generator=generator, dtype=dtype)
        self.monoNmonoFromMem_encoder = AudioCNN(
            hidden_size, encode_mono_n_mono_from_mem=True, generator=generator, dtype=dtype
        )
        n_feats = 2 if blind else 3
        self.state_encoder = GRUStateEncoder(n_feats * hidden_size, hidden_size,
                                             generator=generator, dtype=dtype)

    def features(self, observations, pred_binSepMasks, pred_mono, pred_monoFromMem):
        """A precomputed ``visual_feats`` entry (the evaluator's per-pose
        feature bank) replaces the visual conv stack."""
        feats = []
        if self.visual_encoder is not None:
            vis = observations.get("visual_feats")
            if vis is None:
                if observations.get("rgb") is None and observations.get("depth") is None:
                    raise ValueError(
                        "PolicyNet: the visual encoder is not blind but the "
                        "observations carry no rgb/depth; set EXTRA_RGB and "
                        "EXTRA_DEPTH for a blind agent"
                    )
                vis = self.visual_encoder(
                    rgb=observations.get("rgb"), depth=observations.get("depth")
                )
            feats.append(vis)
        feats.append(self.bin_encoder(
            mixed_log_mag=observations["mixed_bin_audio_mag"],
            pred_bin_sep_masks=pred_binSepMasks,
        ))
        feats.append(self.monoNmonoFromMem_encoder(
            pred_mono_n_mono_from_mem=torch.cat([pred_mono, pred_monoFromMem], dim=-1)
        ))
        return torch.cat(feats, dim=-1)

    def forward(self, observations, hidden, masks, pred_binSepMasks, pred_mono,
                pred_monoFromMem):
        x = self.features(observations, pred_binSepMasks, pred_mono, pred_monoFromMem)
        return self.state_encoder(x, hidden, masks)

    def seq(self, observations, hidden, masks, pred_binSepMasks, pred_mono,
            pred_monoFromMem):
        """Sequence form: observation values (T, N, ...), hidden (N, H),
        masks (T, N, 1). The encoders run over the flattened T*N batch, the
        GRU steps over T. Returns ((T, N, H) outputs, final hidden)."""
        t, n = masks.shape[0], masks.shape[1]

        def flat(v):
            return v.reshape((t * n,) + tuple(v.shape[2:]))

        x = self.features(
            {k: flat(v) for k, v in observations.items()},
            flat(pred_binSepMasks), flat(pred_mono), flat(pred_monoFromMem),
        )
        return self.state_encoder(x.reshape(t, n, -1), hidden, masks)


class Move2HearPolicy(nn.Module):
    """Full agent: policy net + action/critic heads + the five separator
    modules. Weights are drawn as the JAX package draws them (see
    ``models/unet.py``), from `generator` if one is given."""

    def __init__(self, num_actions: int = 4, hidden_size: int = 512,
                 extra_rgb: bool = False, extra_depth: bool = False,
                 use_ddppo: bool = False, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        g, dt = generator, dtype
        self.pol_net = PolicyNet(hidden_size, extra_rgb, extra_depth, generator=g, dtype=dt)
        self.action_dist = CategoricalNet(hidden_size, num_actions, generator=g, dtype=dt)
        self.critic = CriticHead(hidden_size, generator=g, dtype=dt)
        self.binSep_enc = PassiveSepEncoder(convert_bin2mono=False, generator=g, dtype=dt)
        self.binSep_dec = PassiveSepDecoder(convert_bin2mono=False, generator=g, dtype=dt)
        self.bin2mono_enc = PassiveSepEncoder(convert_bin2mono=True, generator=g, dtype=dt)
        self.bin2mono_dec = PassiveSepDecoder(convert_bin2mono=True, generator=g, dtype=dt)
        self.acoustic_mem = AcousticMem(use_ddppo=use_ddppo, generator=g, dtype=dt)

    def visual_features(self, rgb=None, depth=None) -> torch.Tensor:
        """Pol-net visual encodings for a batch of poses."""
        return self.pol_net.visual_encoder(rgb=rgb, depth=depth)

    def get_binSepMasks(self, observations: Observations) -> torch.Tensor:
        bottleneck, skips = self.binSep_enc(
            observations["mixed_bin_audio_mag"],
            target_class=observations["target_class"],
        )
        return self.binSep_dec(bottleneck, skips)

    def convert_bin2mono(self, pred_binSepMasks, mixed_audio) -> torch.Tensor:
        bottleneck, skips = self.bin2mono_enc(
            mixed_audio, pred_bin_sep_masks=pred_binSepMasks.detach()
        )
        return self.bin2mono_dec(bottleneck, skips)

    def get_monoFromMem(self, pred_mono, prev_pred_monoFromMem_masked) -> torch.Tensor:
        return self.acoustic_mem(pred_mono.detach(), prev_pred_monoFromMem_masked.detach())

    def _pol_features(self, observations, hidden, masks, pred_binSepMasks,
                      pred_mono, pred_monoFromMem):
        return self.pol_net(
            observations, hidden, masks, pred_binSepMasks.detach(),
            pred_mono.detach(), pred_monoFromMem.detach(),
        )

    def act(
        self,
        observations: Observations,
        hidden: torch.Tensor,
        masks: torch.Tensor,
        pred_binSepMasks: torch.Tensor,
        pred_mono: torch.Tensor,
        pred_monoFromMem: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = False,
        sampler: Optional[Callable[[Categorical], torch.Tensor]] = None,
        rows: Optional[Tuple[int, int]] = None,
    ) -> ActOutput:
        """`sampler`, if given, draws the (B, 1) actions from the
        distribution in place of ``dist.sample(generator, rows)`` (`rows`:
        this batch's rows of the world's global env batch)."""
        feats, new_hidden = self._pol_features(
            observations, hidden, masks, pred_binSepMasks, pred_mono, pred_monoFromMem
        )
        dist: Categorical = self.action_dist(feats)
        value = self.critic(feats)
        if deterministic:
            action = dist.mode()
        elif sampler is not None:
            action = sampler(dist)
        else:
            action = dist.sample(generator, rows)
        return ActOutput(
            value=value,
            action=action,
            action_log_probs=dist.log_probs(action),
            hidden=new_hidden,
            probs=dist.probs(),
        )

    def get_value(self, observations, hidden, masks, pred_binSepMasks, pred_mono,
                  pred_monoFromMem) -> torch.Tensor:
        feats, _ = self._pol_features(
            observations, hidden, masks, pred_binSepMasks, pred_mono, pred_monoFromMem
        )
        return self.critic(feats)

    def evaluate_actions(self, observations, hidden, masks, action, pred_binSepMasks,
                         pred_mono, pred_monoFromMem, per_step_entropy: bool = False):
        """Sequence evaluation for the PPO update: observation values
        (T, N, ...), hidden (N, H), masks (T, N, 1), action (T, N, 1).
        Returns (values (T, N, 1), log-probs (T, N, 1), mean entropy, or the
        (T, N) entropies when `per_step_entropy`, final hidden)."""
        t, n = masks.shape[0], masks.shape[1]
        feats, new_hidden = self.pol_net.seq(
            observations, hidden, masks, pred_binSepMasks, pred_mono, pred_monoFromMem
        )
        feats_flat = feats.reshape(t * n, -1)
        dist: Categorical = self.action_dist(feats_flat)
        values = self.critic(feats_flat).reshape(t, n, 1)
        log_probs = dist.log_probs(action.reshape(t * n, 1)).reshape(t, n, 1)
        entropy = dist.entropy()
        entropy = entropy.reshape(t, n) if per_step_entropy else entropy.mean()
        return values, log_probs, entropy, new_hidden


class Move2HearPassiveWoMemoryPolicy(nn.Module):
    """The passive pretrain's policy (the reference's
    ``pretrain/passive/policy.py:47-97``): the two passive separator pairs
    under ``Move2HearPolicy``'s names, so the RL trainer copies their
    weights by name. BatchNorm follows the module's mode (``train()`` for
    the pretrain step, ``eval()`` for its validation); `dtype` is the
    compute dtype, as ``Move2HearPolicy``'s."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g, dt = generator, dtype
        self.dtype = dtype
        self.binSep_enc = PassiveSepEncoder(convert_bin2mono=False, generator=g, dtype=dt)
        self.binSep_dec = PassiveSepDecoder(convert_bin2mono=False, generator=g, dtype=dt)
        self.bin2mono_enc = PassiveSepEncoder(convert_bin2mono=True, generator=g, dtype=dt)
        self.bin2mono_dec = PassiveSepDecoder(convert_bin2mono=True, generator=g, dtype=dt)

    def get_binSepMasks(self, observations: Observations) -> torch.Tensor:
        bottleneck, skips = self.binSep_enc(
            observations["mixed_bin_audio_mag"],
            target_class=observations["target_class"],
        )
        return self.binSep_dec(bottleneck, skips)

    def convert_bin2mono(self, pred_binSepMasks, mixed_audio) -> torch.Tensor:
        """The masks enter detached, as the JAX package's ``stop_gradient``:
        the mono loss trains the bin2mono pair only, and no gradient reaches
        masked_mix_slice16's inputs."""
        bottleneck, skips = self.bin2mono_enc(
            mixed_audio, pred_bin_sep_masks=pred_binSepMasks.detach()
        )
        return self.bin2mono_dec(bottleneck, skips)

    def forward(self, observations: Observations):
        """(pred_binSepMasks (B, F, T, 2), pred_mono (B, F, T, 1))."""
        masks = self.get_binSepMasks(observations)
        return masks, self.convert_bin2mono(masks, observations["mixed_bin_audio_mag"])

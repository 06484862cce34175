"""PPO for Move2Hear (``audio_separation/rl/ppo/ppo.py``), the JAX package's
``rl/ppo.py`` on PyTorch.

Two optimizers over disjoint parameter groups (ppo.py:48-55):
  - the pol group (pol_net, action_dist, critic): clipped-surrogate PPO with
    a clipped value loss, normalized advantages and an entropy bonus;
  - the sep group (acoustic_mem): the separator refit. The passive
    separators are frozen: they get no gradient and no optimizer state.

Each optimizer is optax's ``clip_by_global_norm(max_grad_norm) ->
scale_by_adam(eps) -> scale(-lr * lr_scale)``, the JAX package's chain:
the clip is written out (``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6``; optax scales by ``max_norm / norm`` only when
``norm >= max_norm``), and the Adam step is ``torch.optim.Adam``'s, whose
formula is ``scale_by_adam``'s, with the learning rate set per update.

Unlike the JAX package's pure functions, the update functions here change
the policy's parameters and the optimizer states in place.

``make_update_sep`` is the host env path's separator refit: it renders the
spectrograms anew from the stored render keys (``rl/rollout.py:
RolloutSep``). The device path refits from the outputs its collect cached
(``rl/device_rollout.py:make_update_sep_from_slabs``).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from move2hear_tpu_torch.models.policy import Move2HearPolicy
from move2hear_tpu_torch.ops.frontend import render_binaural_mixture
from move2hear_tpu_torch.parallel.dist import (
    all_reduce_,
    all_reduce_grads,
    distributed_mean_var,
    world,
)
from move2hear_tpu_torch.utils.torch_import import refuse_reference_layout

EPS_PPO = 1e-5

POL_KEYS = ("pol_net", "action_dist", "critic")
SEP_TRAIN_KEYS = ("acoustic_mem",)
PASSIVE_KEYS = ("binSep_enc", "binSep_dec", "bin2mono_enc", "bin2mono_dec")


@dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.1
    ppo_epoch: int = 4
    num_mini_batch: int = 1
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.2
    lr_pol: float = 1e-4
    lr_sep: float = 5e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.5
    use_clipped_value_loss: bool = True
    use_normalized_advantage: bool = True
    use_gae: bool = True
    gamma: float = 0.99
    tau: float = 0.95


def group_params(policy: Move2HearPolicy, keys) -> List[torch.nn.Parameter]:
    """Parameters of the top-level submodules named in `keys`, in
    ``named_parameters`` order."""
    return [p for name, p in policy.named_parameters() if name.split(".")[0] in keys]


class ClippedAdam:
    """optax ``clip_by_global_norm -> scale_by_adam -> scale(-lr)`` over one
    parameter group. A parameter the loss did not reach gets a zero gradient,
    as in JAX, so its Adam moments still decay."""

    def __init__(self, params: List[torch.nn.Parameter], max_grad_norm: float, eps: float):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=1.0, betas=(0.9, 0.999), eps=eps)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, lr: float, extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """In a world of ranks the gradients are first summed over it, with
        `extra` (the step's logged loss shares) in the same all-reduce;
        returns `extra` summed."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        extra = all_reduce_grads(self.params, extra)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                            self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        return extra

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


@dataclass
class AgentState:
    """The policy (parameters and BatchNorm statistics) and both optimizers."""

    policy: Move2HearPolicy
    opt_pol: ClippedAdam
    opt_sep: ClippedAdam


def make_optimizers(cfg: PPOConfig, policy: Move2HearPolicy):
    return (
        ClippedAdam(group_params(policy, POL_KEYS), cfg.max_grad_norm, cfg.eps),
        ClippedAdam(group_params(policy, SEP_TRAIN_KEYS), cfg.max_grad_norm, cfg.eps),
    )


def create_agent_state(cfg: PPOConfig, policy: Move2HearPolicy) -> AgentState:
    """Freezes the passive separators (no gradient, no optimizer state) and
    builds both optimizers. The policy stays in eval mode for good (but for
    its GRU, which has no mode-dependent layer): the passive U-Nets and,
    without DDPPO, the acoustic memory use their BatchNorm running
    statistics throughout training, as in JAX."""
    for p in group_params(policy, PASSIVE_KEYS):
        p.requires_grad_(False)
    policy.eval()
    # nn.GRU has no dropout, so its two modes compute the same; cuDNN's RNN
    # backward runs only in training mode
    policy.pol_net.state_encoder.rnn.train()
    opt_pol, opt_sep = make_optimizers(cfg, policy)
    return AgentState(policy, opt_pol, opt_sep)


def load_pretrained_passive_separators(policy: Move2HearPolicy, state_dict: Dict[str, torch.Tensor]):
    """Copy the four passive-separator subtrees by name from a port state
    dict (ppo.py:59-70). Every tensor of those subtrees must be there with
    its shape, as the JAX package's loader indexes each subtree: a dict that
    lacks any (``{}``, another file, a reference checkpoint that was not
    converted) raises ``KeyError`` naming the missing keys, and a shape
    mismatch or an unknown passive key raises ``ValueError``. Nothing is
    copied unless everything checks."""
    own = policy.state_dict()
    wanted = [k for k in own if k.split(".")[0] in PASSIVE_KEYS]
    missing = [k for k in wanted if k not in state_dict]
    if missing:
        refuse_reference_layout(state_dict, "the pretrained passive separators")
        raise KeyError(
            f"the pretrained passive separators lack {len(missing)} of their "
            f"{len(wanted)} tensors: {missing[:4]}{' ...' if len(missing) > 4 else ''}"
        )
    for name, value in state_dict.items():
        if name.split(".")[0] not in PASSIVE_KEYS:
            continue
        if name not in own or own[name].shape != value.shape:
            raise ValueError(
                f"shape mismatch in {name}: "
                f"{tuple(own[name].shape) if name in own else None} vs {tuple(value.shape)}"
            )
    for name in wanted:
        own[name].copy_(state_dict[name])


def _normalized_advantages(advantages: torch.Tensor, use_normalized: bool) -> torch.Tensor:
    if not use_normalized:
        return advantages
    return (advantages - advantages.mean()) / (advantages.std() + EPS_PPO)


def _world_normalized_advantages(advantages: torch.Tensor, w: Optional[torch.Tensor],
                                 use_normalized: bool) -> torch.Tensor:
    """The normalisation over the world's advantages, those of weight `w`
    only when given: the global mean and unbiased n/(n-1) variance, as the
    JAX package's pmean and its validity-weighted sums (rl/ppo.py:113-158);
    with a world of one and `w`, that of the physically truncated buffer."""
    if not use_normalized:
        return advantages
    mean, var = distributed_mean_var(advantages, w)
    return (advantages - mean) / (torch.sqrt(var) + EPS_PPO)


def _rank_members(idx: torch.Tensor, rank: int, num_envs: int, size: int) -> torch.Tensor:
    """This rank's local env indices among the global env indices `idx` of
    a minibatch (rank r holds global envs [r * num_envs, (r + 1) *
    num_envs))."""
    if size == 1:
        return idx
    lo = rank * num_envs
    return idx[(idx >= lo) & (idx < lo + num_envs)] - lo


def _epoch_perms(generator: Optional[torch.Generator], ppo_epoch: int, num_envs: int,
                 num_mini_batch: int, device=None) -> torch.Tensor:
    """(ppo_epoch * num_mini_batch, envs_per_batch) env-index table: each
    epoch permutes the envs and splits them into minibatches
    (rollout_storage.py:195-197)."""
    assert num_envs >= num_mini_batch, (
        f"need num_envs ({num_envs}) >= num_mini_batch ({num_mini_batch})"
    )
    envs_per = num_envs // num_mini_batch
    perms = torch.stack([
        torch.randperm(num_envs, generator=generator, device=device) for _ in range(ppo_epoch)
    ])
    return perms[:, : envs_per * num_mini_batch].reshape(-1, envs_per)


def _rollout_minibatch(rollouts, sel) -> Dict:
    """The update's inputs of the envs `sel` (a slice or an index tensor)
    of a rollout, but for the advantages and the step weights."""
    return {
        "obs": {k: v[:-1, sel] for k, v in rollouts["observations"].items()},
        "hidden0": rollouts["hidden"][0, sel],
        "masks": rollouts["masks"][:-1, sel],
        "actions": rollouts["actions"][:, sel],
        "pred_binSepMasks": rollouts["pred_binSepMasks"][:, sel],
        "pred_mono": rollouts["pred_mono"][:, sel],
        "pred_monoFromMem": rollouts["prev_pred_monoFromMem"][1:, sel],
        "value_preds": rollouts["value_preds"][:-1, sel],
        "returns": rollouts["returns"][:-1, sel],
        "old_log_probs": rollouts["action_log_probs"][:, sel],
    }


def _update_forward(policy: Move2HearPolicy, mb, banks, pose_bank: bool,
                    per_step_entropy: bool):
    """The policy update's forward over a minibatch: (values, action
    log-probs, entropy, ...) of ``evaluate_actions``; with `pose_bank` the
    visual encoder runs once over the S*V*4 poses of `banks` and each step
    gathers its row, else it runs over the stored frames."""
    obs = mb["obs"]
    if pose_bank:
        def flat(b):
            return None if b is None else b.reshape((-1,) + tuple(b.shape[3:]))

        vis = policy.visual_features(flat(banks.get("rgb")), flat(banks.get("depth")))
        obs = {k: v for k, v in obs.items() if k != "pose"}
        obs["visual_feats"] = vis[mb["obs"]["pose"]]
    return policy.evaluate_actions(
        obs, mb["hidden0"], mb["masks"], mb["actions"], mb["pred_binSepMasks"],
        mb["pred_mono"], mb["pred_monoFromMem"], per_step_entropy=per_step_entropy,
    )


def rollout_forward(policy: Move2HearPolicy, rollouts, banks=None, pose_bank: bool = False):
    """(values, action log-probs, entropy) of the policy update's forward
    over a whole rollout, as an epoch of one minibatch runs it before its
    optimizer step: over pose indices and `banks` with `pose_bank`, over the
    stored frames without."""
    values, log_probs, entropy, _ = _update_forward(
        policy, _rollout_minibatch(rollouts, slice(None)), banks, pose_bank, False)
    return values, log_probs, entropy


def make_update_pol(policy: Move2HearPolicy, cfg: PPOConfig, num_envs: int,
                    pose_bank: bool = False, with_validity: bool = False):
    """The policy update: ``update(state, rollouts, generator, lr_scale,
    clip_scale, banks=None, t_valid=None)`` runs ppo_epoch x num_mini_batch
    steps over the rollout (``returns`` already computed) and returns the
    (value_loss, action_loss, entropy) means over all minibatches as a (3,)
    tensor.

    With `pose_bank` the observations carry an integer ``pose`` index in
    place of the frames; each step runs the visual encoder once over the
    S*V*4 poses of `banks` (with gradients) and gathers a row per step.

    With `with_validity` the steps from `t_valid` on (not collected when the
    DDPPO preemptive sync cut the rollout) weigh nothing in the
    normalisation and the losses: the update equals the plain one on the
    physically truncated rollout.

    In a world of ranks (``parallel/dist.py``) `num_envs` is this rank's
    envs; the advantages are normalised over the world, each rank's loss is
    its share of the global minibatch mean (the sum over its rows divided by
    the global row count), and the optimiser sums the gradients, so R ranks
    x N envs compute what one rank of R*N envs does. With num_mini_batch >
    1 every rank draws the permutation of the global env axis and takes its
    members."""
    rank, size = world()
    # losses as shares of a global count: the plain means otherwise, which a
    # world of one keeps
    shares = size > 1 or with_validity

    def minibatch_loss(mb, clip_param, banks, count):
        values, log_probs, entropy, _ = _update_forward(policy, mb, banks, pose_bank, shares)
        ratio = torch.exp(log_probs - mb["old_log_probs"])
        surr1 = ratio * mb["adv"]
        surr2 = torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * mb["adv"]
        if cfg.use_clipped_value_loss:
            clipped = mb["value_preds"] + torch.clamp(
                values - mb["value_preds"], -clip_param, clip_param
            )
            value_sq = torch.maximum(
                torch.square(values - mb["returns"]), torch.square(clipped - mb["returns"])
            )
        else:
            value_sq = torch.square(mb["returns"] - values)
        if shares:
            def share(x):
                return (x if mb["w"] is None else x * mb["w"]).sum() / count

            action_loss = -share(torch.minimum(surr1, surr2))
            value_loss = 0.5 * share(value_sq)
            entropy = share(entropy[..., None])
        else:
            action_loss = -torch.minimum(surr1, surr2).mean()
            value_loss = 0.5 * value_sq.mean()
        total = value_loss * cfg.value_loss_coef + action_loss - entropy * cfg.entropy_coef
        return total, torch.stack([value_loss, action_loss, entropy]).detach()

    def update(state: AgentState, rollouts, generator=None, lr_scale=1.0, clip_scale=1.0,
               banks=None, t_valid=None):
        clip_param = cfg.clip_param * clip_scale
        lr = cfg.lr_pol * lr_scale
        adv_all = rollouts["returns"][:-1] - rollouts["value_preds"][:-1]
        t_all = adv_all.shape[0]
        t_used = t_all if t_valid is None else int(t_valid)
        w_steps = None
        if with_validity:
            w_steps = (torch.arange(t_all, device=adv_all.device) < t_used).to(
                adv_all.dtype).reshape(t_all, 1, 1)
        if shares:
            adv_all = _world_normalized_advantages(adv_all, w_steps,
                                                   cfg.use_normalized_advantage)
        else:
            adv_all = _normalized_advantages(adv_all, cfg.use_normalized_advantage)
        # num_mini_batch == 1 (the published config): each minibatch is all
        # envs, and a batch-mean gradient does not depend on their order, so
        # no permuted gather
        full_batch = cfg.num_mini_batch == 1
        if full_batch:
            perms = [None] * cfg.ppo_epoch
        else:
            perms = _epoch_perms(generator, cfg.ppo_epoch, num_envs * size, cfg.num_mini_batch,
                                 device=adv_all.device)
        envs_per = num_envs * size // cfg.num_mini_batch
        count = float(t_used * envs_per)
        aux = []
        for idx in perms:
            sel = slice(None) if idx is None else _rank_members(idx, rank, num_envs, size)
            mb = {**_rollout_minibatch(rollouts, sel), "adv": adv_all[:, sel], "w": w_steps}
            state.opt_pol.zero_grad()
            if isinstance(sel, torch.Tensor) and sel.numel() == 0:
                # none of this minibatch's envs is on this rank: its share is 0
                losses = torch.zeros(3, device=adv_all.device)
            else:
                total, losses = minibatch_loss(mb, clip_param, banks, count)
                total.backward()
            # the shares sum to the world's losses (a world of one keeps its own)
            aux.append(state.opt_pol.step(lr, extra=losses))
        return torch.stack(aux).mean(dim=0)

    return update


def make_update_sep(policy: Move2HearPolicy, cfg: PPOConfig, num_envs: int,
                    gt_mono_mag_norm: float = 0.0, chunk_rows: Optional[int] = None,
                    with_validity: bool = False):
    """The separator refit of the host env path (``ppo.py:179-246``; the JAX
    package's ``rl/ppo.py:make_update_sep``): ``update(state, rollouts,
    bank, generator=None, lr_scale=1.0)`` -> (bin L1, mono L1, memory L1)
    means over the ppo_epoch x num_mini_batch steps, a (3,) tensor.

    The spectrograms are rendered anew on the device from the stored
    (sound id, RIR) keys, magnitudes only. The passive separators are
    frozen and their BatchNorm uses running statistics, so their outputs
    are the same in every epoch: the update renders and runs them once, in
    chunks of `chunk_rows` buffer rows (all rows when None), without
    gradients; then each step trains the acoustic memory on the L1 loss of
    its prediction against the GT mono magnitude. The bin and mono losses
    are logged only.

    With `with_validity` the update takes ``row_weights`` ((T_total,)): the
    rows that the preemptive sync left stale this cycle weigh nothing in
    the losses and the logged means. In a world of ranks each loss is the
    rank's share of the global mean and the gradients and logged losses are
    summed over it, as in ``make_update_pol``."""
    rank, size = world()
    shares = size > 1 or with_validity

    def update(state: AgentState, rollouts, bank, generator=None, lr_scale=1.0,
               row_weights=None):
        lr = cfg.lr_sep * lr_scale
        masks = rollouts["masks"][:-1]
        rows, n = masks.shape[0], masks.shape[1]
        if shares:
            # per-row weights, (rows, 1), and the world's count of weighted rows
            w_rows = (torch.ones((rows, 1), device=masks.device) if row_weights is None
                      else row_weights.reshape(rows, 1).to(masks.dtype))
            wsum = float(rows if row_weights is None else row_weights.sum())
        chunk = chunk_rows or rows
        pred_mono, gt_mono, bin_l1, mono_l1 = [], [], [], []
        with torch.no_grad():
            for r0 in range(0, rows, chunk):
                sl = slice(r0, min(rows, r0 + chunk))

                def flat(v):
                    v = v[sl]
                    return v.reshape((v.shape[0] * n,) + tuple(v.shape[2:]))

                rendered = render_binaural_mixture(
                    bank[flat(rollouts["sound_ids"])], flat(rollouts["rirs"]),
                    gt_mono_mag_norm=gt_mono_mag_norm, mags_only=True,
                )
                mix = rendered.mixed_bin_audio_mag
                pm = policy.get_binSepMasks(
                    {"mixed_bin_audio_mag": mix, "target_class": flat(rollouts["target_class"])}
                )
                mono = policy.convert_bin2mono(pm, mix)
                gt = rendered.gt_mono_comps[..., 0::2][..., :1]
                gt_bin = rendered.gt_bin_comps[..., 0::2][..., :2]
                bin_l1.append(torch.abs(torch.expm1(mix) * pm - gt_bin).mean(dim=(1, 2, 3)))
                mono_l1.append(torch.abs(mono - gt).mean(dim=(1, 2, 3)))
                pred_mono.append(mono.reshape((-1, n) + tuple(mono.shape[1:])))
                gt_mono.append(gt.reshape((-1, n) + tuple(gt.shape[1:])))
        pred_mono, gt_mono = torch.cat(pred_mono), torch.cat(gt_mono)
        prev_masked = rollouts["prev_pred_monoFromMem"][:-1] * masks[:, :, :, None, None]
        if shares:
            # the per-sample means, weighted by row, as shares of the global mean
            logged = torch.stack([
                (torch.cat(l1).reshape(rows, n) * w_rows).sum() / max(wsum * n * size, 1.0)
                for l1 in (bin_l1, mono_l1)
            ])
            bin_loss, mono_loss = all_reduce_(logged)
        else:
            bin_loss, mono_loss = torch.cat(bin_l1).mean(), torch.cat(mono_l1).mean()

        if cfg.num_mini_batch == 1:
            # full batch: a batch-mean gradient does not depend on env order
            perms = [None] * cfg.ppo_epoch
        else:
            perms = _epoch_perms(generator, cfg.ppo_epoch, num_envs * size, cfg.num_mini_batch,
                                 device=masks.device)
        if shares:
            mb_count = max(wsum * (n * size // cfg.num_mini_batch), 1.0)
        mem_losses = []
        for idx in perms:
            sel = slice(None) if idx is None else _rank_members(idx, rank, num_envs, size)

            def flat_sel(v):
                v = v[:, sel]
                return v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))

            state.opt_sep.zero_grad()
            if isinstance(sel, torch.Tensor) and sel.numel() == 0:
                loss = torch.zeros((), device=masks.device)
            else:
                pred_mem = policy.get_monoFromMem(flat_sel(pred_mono), flat_sel(prev_masked))
                err = torch.abs(pred_mem - flat_sel(gt_mono))
                if shares:
                    per = err.mean(dim=(1, 2, 3)) * flat_sel(w_rows.expand(rows, n))
                    loss = per.sum() / mb_count
                else:
                    loss = err.mean()
                loss.backward()
            mem_losses.append(state.opt_sep.step(lr, extra=loss.detach().reshape(1))[0])
        return torch.stack([bin_loss, mono_loss, torch.stack(mem_losses).mean()])

    return update

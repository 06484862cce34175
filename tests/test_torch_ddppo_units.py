"""DDPPO's pieces in the port against the JAX package's on the CPU: the
advantage normalisation over a world (weighted by step validity or not)
against JAX's pmean and psum under a named axis; BatchNorm's statistics
over a world against one process's whole batch; the generation-keyed
num-done store on a TCPStore across two processes; the rank rows of the
action draw; ``concat_collect_outputs`` against the unsplit collect and
JAX's function; the interrupted state's path, JAX's string, and a snapshot
the port cannot read; the backend choice. The worlds are 2 spawned gloo
processes (``tests/_torch_ddppo_rank.py:run_in_world``)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ddppo_rank import run_in_world
from move2hear_tpu.parallel import ddppo as jddppo
from move2hear_tpu.rl import device_rollout as jdr
from move2hear_tpu.rl import ppo as jppo
from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.main import main as port_main
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.models.distributions import Categorical
from move2hear_tpu_torch.parallel import ddppo
from move2hear_tpu_torch.rl import device_rollout as tdr
from move2hear_tpu_torch.rl import ppo as tppo
from _torch_threads import cap_torch_threads

cap_torch_threads()

T, N = 6, 4


@pytest.mark.parametrize("weighted", [False, True])
def test_world_advantage_normalisation_matches_jax(weighted):
    """2 ranks x 2 envs normalise as JAX's sharded program over the named
    axis, and as one rank of 4 envs; with step weights, as the physically
    truncated buffer."""
    rng = np.random.default_rng(0)
    adv = rng.standard_normal((T, N, 1))
    w = (np.arange(T) < 4).astype(np.float64).reshape(T, 1, 1) if weighted else None
    with jax.enable_x64(True):
        shards = jnp.asarray(np.stack([adv[:, :2], adv[:, 2:]]))
        if weighted:
            ref = jax.vmap(lambda a: jppo._weighted_normalized_advantages(
                a, jnp.asarray(w), True, "i"), axis_name="i")(shards)
        else:
            ref = jax.vmap(lambda a: jppo._normalized_advantages(a, True, "i"),
                           axis_name="i")(shards)
    ref = np.concatenate(list(np.asarray(ref)), axis=1)
    world = np.concatenate(run_in_world("normalised_shard", 2, adv, w), axis=1)
    one = tppo._world_normalized_advantages(torch.from_numpy(adv),
                                            None if w is None else torch.from_numpy(w), True)
    valid = slice(None, 4 if weighted else None)
    np.testing.assert_allclose(world[valid], ref[valid], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(one.numpy()[valid], ref[valid], rtol=1e-12, atol=1e-12)
    if weighted:
        trunc = tppo._normalized_advantages(torch.from_numpy(adv[:4]), True)
        np.testing.assert_allclose(world[:4], trunc.numpy(), rtol=1e-12, atol=1e-12)


def test_batchnorm_takes_the_world_batch_statistics():
    """2 ranks x 3 rows in training mode: outputs, input gradients, the
    parameters' summed gradients and the running statistics of one
    process's 6 rows (float64)."""
    rng = np.random.default_rng(1)
    x, g = rng.standard_normal((6, 3, 4, 5)), rng.standard_normal((6, 3, 4, 5))
    ranks = run_in_world("batchnorm_shard", 2, x, g)
    out, dx, dw, mean, var = _batchnorm_one(x, g)
    np.testing.assert_allclose(np.concatenate([r[0] for r in ranks]), out, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([r[1] for r in ranks]), dx, rtol=1e-9, atol=1e-12)
    for r in ranks:
        np.testing.assert_allclose(r[2], dw, rtol=1e-10)
        np.testing.assert_allclose(r[3], mean, rtol=1e-10)
        np.testing.assert_allclose(r[4], var, rtol=1e-10)


def _batchnorm_one(x, g):
    from move2hear_tpu_torch.models.unet import BatchNorm2d

    bn = BatchNorm2d(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    xs = torch.from_numpy(x).requires_grad_(True)
    out = bn(xs)
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(), xs.grad.numpy(), torch.cat([bn.weight.grad, bn.bias.grad]).numpy(),
            bn.running_mean.numpy(), bn.running_var.numpy())


def test_pretrain_refuses_a_batch_the_world_does_not_divide():
    errors = run_in_world("pretrain_refusal", 2, 3)
    assert all("BATCH_SIZE 3 is not divisible by the world's 2 ranks" in e for e in errors)
    assert run_in_world("pretrain_refusal", 2, 4) == [None, None]


def test_tcp_store_counts_each_generation_across_processes():
    """A late rank entering the next generation does not erase the marks
    of the current one (tests/test_preemptive_sync.py's race, on the
    TCPStore the port keeps on master_port + 1)."""
    from _torch_ddppo_rank import free_port

    r0, r1 = run_in_world("store_generations", 2, free_port())
    assert r0["gen1_before"] == r1["gen1_before"] == 1
    assert r0["stop_at_1"] and r1["stop_at_1"]  # 1 > 0.4 * 2 ranks past 0.25 * T
    assert r0["gen1_after"] == r1["gen1_after"] == 2 and r0["gen2"] == r1["gen2"] == 0
    assert r0["stop_at_4"] and not r1["stop_at_4"]


def test_each_rank_samples_its_rows_of_one_global_draw():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    whole = Categorical(logits).sample(torch.Generator().manual_seed(5))
    parts = [Categorical(logits[r * 4: (r + 1) * 4]).sample(
        torch.Generator().manual_seed(5), rows=(r * 4, 8)) for r in range(2)]
    assert torch.equal(torch.cat(parts), whole)
    # the inverse-CDF draw follows the probabilities
    probs = torch.tensor([[0.1, 0.6, 0.3]])
    draws = Categorical(probs.log().expand(200000, 3)).sample(torch.Generator().manual_seed(0))
    freq = torch.bincount(draws[:, 0], minlength=3).double() / 200000
    np.testing.assert_allclose(freq.numpy(), probs[0].numpy(), atol=5e-3)


def test_concat_collect_outputs_joins_a_split_rollout():
    """A prefix of 2 steps and a tail of 2 joined equal one collect of 4
    steps (the generator continues across the split), and the joined
    returns are JAX's concat_collect_outputs of the same segments."""
    hid, codes = 32, (1, 2, 3)
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, hid, use_ddppo=True).eval()
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400)
    dev = de.build_device_bundle(bundle, "cpu")
    cfg = tppo.PPOConfig()

    def collect(t, env, h, m, pm, gen):
        return tdr.make_collect(policy, cfg, t, 3, 1.2, 10.0, codes,
                                ("mixed_bin_audio_mag", "target_class"))(dev, env, h, m, pm, gen)

    def start():
        env = de.env_reset_all(dev.scene, dev.episodes, torch.as_tensor(de.make_order_table(2, 4, 0)))
        return env, torch.zeros((2, hid)), torch.ones((2, 1)), torch.zeros((2, 512, 32, 1))

    whole = collect(4, *start(), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    pre = collect(2, *start(), gen)
    tail = collect(2, pre.env_state, pre.hidden, pre.masks, pre.prev_mem_masked, gen)
    joined = tdr.concat_collect_outputs(pre, tail, cfg)
    for k, v in whole.rollouts_pol.items():
        got = joined.rollouts_pol[k]
        for name, a, b in ([(s, got[s], v[s]) for s in v] if isinstance(v, dict) else [(k, got, v)]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    for k, v in whole.sep_slab.items():
        torch.testing.assert_close(joined.sep_slab[k], v, rtol=1e-5, atol=1e-6, msg=k)
    torch.testing.assert_close(joined.stats, whole.stats, rtol=1e-5, atol=1e-6)

    def j(out):
        return jdr.CollectOutput(None, None, None, None,
                                 jax.tree.map(lambda a: jnp.asarray(a.numpy()), out.rollouts_pol),
                                 jax.tree.map(lambda a: jnp.asarray(a.numpy()), out.sep_slab),
                                 jnp.asarray(out.stats.numpy()))

    ref = jdr.concat_collect_outputs(j(pre), j(tail), jppo.PPOConfig())
    for k in ("returns", "value_preds", "masks", "rewards", "actions", "hidden"):
        np.testing.assert_allclose(joined.rollouts_pol[k].numpy(), np.asarray(ref.rollouts_pol[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_interrupted_state_paths_are_the_jax_packages(monkeypatch, tmp_path, caplog):
    monkeypatch.setenv("INTERRUPTED_STATE_DIR", str(tmp_path))
    for job, scope in ((1, ""), (1, "PPOTrainer:/runs/a/data"), ("77", "PassiveTrainer:x")):
        assert ddppo.interrupted_state_path(job, scope) == jddppo.interrupted_state_path(job, scope)
    # a JAX-package snapshot under the same scope is ignored with a warning
    jddppo.save_interrupted_state({"params": {"w": np.ones(2, np.float32)},
                                   "extra_state": {"update_count": 3}}, 1, scope="S")
    with caplog.at_level(logging.WARNING):
        assert ddppo.load_interrupted_state(1, scope="S") is None
    assert "cannot read" in caplog.text
    ddppo.save_interrupted_state({"extra_state": {"update_count": 3}}, 1, scope="S")
    assert ddppo.load_interrupted_state(1, scope="S")["extra_state"]["update_count"] == 3


def test_backend_is_the_configs_and_only_nccl_or_gloo(tmp_path):
    assert ddppo.torch_backend("NCCL") == "nccl" and ddppo.torch_backend("gloo") == "gloo"
    for bad in ("ICI", "MPI", ""):
        with pytest.raises(ValueError, match="ddppo_distrib_backend"):
            ddppo.torch_backend(bad)
    # a world of one initialises nothing
    assert ddppo.init_distributed("GLOO") == (0, 0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="ddppo_distrib_backend"):
        port_main(["--run-type", "train", "--exp-config", "configs/train/nearTarget.yaml",
                   "--model-dir", str(tmp_path), "--device", "cpu",
                   "RL.PPO.ddppo_distrib_backend", "ICI"])
    assert not (tmp_path / "data").exists()  # refused before any training

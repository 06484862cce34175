"""The bfloat16 storage knobs and REPORT_MFU's reach, on the CPU, against the
JAX package where it has the same function:

- ``TPU.SUB_BANK_DTYPE`` bfloat16: the slab's rows are bitwise the JAX
  package's (its rows are cast with ``ml_dtypes``, the port's with torch,
  both rounding to nearest even), each row 2 bytes a sample; the gather
  widens them to float32, bitwise the dense bank's values rounded to
  bfloat16; the gate's byte counts are the JAX trainer's formula at 2 bytes;
- ``REPORT_MFU``: ``mfu_info`` stays None on the host path and in a world
  of 2 ranks over gloo (the count covers one rank's device path);
- the device evaluator runs float32 whatever ``TPU.COMPUTE_DTYPE`` says, as
  the JAX package's: its dumps under bfloat16 are bitwise those under
  float32.

The 2-scene fixture of tests/test_torch_sub_bank.py (RIR length 300)."""

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from move2hear_tpu.env import sub_bank as jsb
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.env import sub_bank as tsb
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.checkpoint import save_checkpoint
from _torch_ddppo_rank import finish, launch_world, train_argv
from test_torch_sub_bank import R, _jax_bank, _port_bank, _two_scene

import jax.numpy as jnp
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID = 32


def test_bf16_sub_bank_rows_are_the_jax_packages_bitwise():
    j_bundle, bundle = _two_scene("jax"), _two_scene("torch")
    n_envs, horizon, t_steps = 2, 3, 3
    order = de.make_order_table(n_envs, len(bundle.episodes), seed=7)
    ours = _port_bank(bundle, order, horizon, t_steps, capacity=8, dtype=torch.bfloat16)
    ref = _jax_bank(j_bundle, order, horizon, t_steps, capacity=8, dtype=jnp.bfloat16)
    assert ours.row_bytes == 4 * 9 * R * 2 * 2
    for _ in range(6):
        slab, _ = ours.rollout_inputs()
        j_slab, _ = ref.rollout_inputs()
        assert slab.dtype == torch.bfloat16
        assert ours._slot_key == ref._slot_key
        np.testing.assert_array_equal(slab.view(torch.int16).numpy(),
                                      np.asarray(j_slab).view(np.int16))
        ours.advance(t_steps)
        ref.advance(t_steps)
    assert ours.rows_uploaded > ours.capacity  # rows were evicted and uploaded again
    assert ours.bytes_uploaded == ours.rows_uploaded * ours.row_bytes
    cached = next(iter(ours._host_cache.values()))
    assert cached.dtype == torch.bfloat16  # cast before the host cache: half its bytes


def test_bf16_gather_is_the_dense_bank_rounded_to_bfloat16():
    bundle = _two_scene("torch")
    order = de.make_order_table(2, len(bundle.episodes), seed=5)
    dense = de.build_device_bundle(bundle, "cpu", precompute_rir_rfft=False)
    sub_dev = de.build_device_bundle(bundle, "cpu", rir_mode="sub")
    sub = _port_bank(bundle, order, 3, 3, dtype=torch.bfloat16)
    slab, table = sub.rollout_inputs()
    sub_dev = dataclasses.replace(sub_dev, rir_sub_bank=slab, ep_src_row=table)
    state = de.env_reset_all(dense.scene, dense.episodes, torch.as_tensor(order))
    obs = de.observe(dense.episodes, state)
    got = de.gather_sensors(sub_dev, obs)["rirs"]
    want = de.gather_sensors(dense, obs)["rirs"]
    assert got.dtype == torch.float32 and got.abs().sum() > 0
    assert torch.equal(got, want.to(torch.bfloat16).float())


def test_gate_bytes_are_the_jax_trainers_at_two_bytes_a_sample(tmp_path):
    """The gate's estimate and the slab's sizing at 2 bytes a sample, as
    the JAX trainer reckons them (``4 * V * R * 2 * 2`` a row); under a
    budget that binds, the bfloat16 slab holds twice the float32 one's rows."""
    j_bundle, bundle = _two_scene("jax"), _two_scene("torch")
    for args in [(2, 2, 3, 4), (14, 2, 20, 20)]:
        assert (tsb.estimate_sub_bank_bytes(bundle, *args, dtype_bytes=2)
                == jsb.estimate_sub_bank_bytes(j_bundle, *args, dtype_bytes=2))
    assert tsb.row_bytes(9, R, 2) == 4 * 9 * R * 2 * 2
    caps = {}
    for dtype in ("float32", "bfloat16"):
        row = tsb.row_bytes(9, R, 2 if dtype == "bfloat16" else 4)
        budget = tsb.fixed_bank_bytes(bundle) + 8 * tsb.row_bytes(9, R, 4)
        cfg = get_config("configs/train/nearTarget.yaml", [
            "NUM_PROCESSES", "2", "RL.PPO.num_steps", "3", "RL.PPO.hidden_size", str(HID),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.SUB_BANK_DTYPE", dtype,
            "TPU.MAX_DEVICE_BANK_BYTES", str(budget)], str(tmp_path / dtype), "train")
        trainer = PPOTrainer(cfg, bundle=bundle, device="cpu")
        dev = de.build_device_bundle(bundle, "cpu", rir_mode="sub")
        order = de.make_order_table(2, len(bundle.episodes), seed=0)
        sub = trainer._make_sub_bank(bundle, dev, order, "cpu")
        n_keys = tsb._count_unique_keys(bundle)
        min_cap = tsb.sub_bank_capacity(2, 2, 3, 3, n_keys)
        # the JAX trainer's sizing (move2hear_tpu/rl/trainer.py, sub mode)
        want = jsb.max_capacity_for_budget(budget - jsb.fixed_bank_bytes(j_bundle), row,
                                           min_cap, n_keys)
        assert sub.capacity == want and sub.row_bytes == row
        caps[dtype] = sub.capacity
    assert caps["bfloat16"] == min(2 * caps["float32"], tsb._count_unique_keys(bundle))


def test_report_mfu_stays_none_on_the_host_path(tmp_path):
    cfg = get_config("configs/train/nearTarget.yaml", [
        "NUM_PROCESSES", "2", "NUM_UPDATES", "1", "RL.PPO.num_updates_per_cycle", "1",
        "RL.PPO.num_steps", "2", "RL.PPO.ppo_epoch", "1", "RL.PPO.hidden_size", str(HID),
        "RL.PPO.pretrained_passive_separators_ckpt", "", "CHECKPOINT_INTERVAL", "1000",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.RIR_MODE", "host",
        "USE_SYNC_VECENV", "True", "TPU.REPORT_MFU", "True"], str(tmp_path), "train")
    trainer = PPOTrainer(cfg, bundle=build_micro_scene(rows=3, cols=3, num_episodes=8,
                                                       rir_length=300), device="cpu")
    trainer.train()
    assert trainer._rir_mode == "host" and trainer.mfu_info is None
    shutil.rmtree(tmp_path)  # the checkpoint


def test_report_mfu_stays_none_in_a_world_of_two_ranks(tmp_path):
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    logs = finish(launch_world(outs, train_argv(tmp_path / "world", "NUM_PROCESSES", "2",
                                                "TPU.REPORT_MFU", "True")))
    assert "a world of one rank only" in logs[0]
    assert all(torch.load(o, weights_only=False)["mfu_info"] is None for o in outs)
    shutil.rmtree(tmp_path)


def test_device_evaluator_runs_float32_whatever_compute_dtype_says(tmp_path):
    ckpt = str(tmp_path / "ckpt.0.pth")
    torch.manual_seed(0)
    policy = Move2HearPolicy(3, HID, extra_depth=True, use_ddppo=True)
    save_checkpoint(ckpt, {"state_dict": policy.state_dict(), "config": {}})
    dumps = {}
    for dtype in ("float32", "bfloat16"):
        out = tmp_path / dtype
        cfg = get_config("configs/test/nearTarget.yaml", [
            "RL.PPO.hidden_size", str(HID), "EVAL_EPISODE_COUNT", "2",
            "TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_RIR_LENGTH", "300",
            "TPU.COMPUTE_DTYPE", dtype], str(out), "eval")
        trainer = PPOTrainer(cfg, device="cpu")
        trainer._eval_checkpoint(ckpt)
        assert trainer._eval_route == "device"
        with open(os.path.join(cfg.MODEL_DIR, f"{cfg.EVAL.SPLIT}_stats_ckpt_0_{cfg.SEED}.json")) as f:
            dumps[dtype] = json.load(f)
    assert dumps["bfloat16"] == dumps["float32"]
    shutil.rmtree(tmp_path)

"""One rank of a port run, for the DDPPO tests: runs
``move2hear_tpu_torch.main.main`` with the given arguments (RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment make it a rank
of a world) and saves what the tests compare: the final state dict, the
loss log, the refit buffer's fill and ``mfu_info``, with ``torch.save``. TensorBoard and
the checkpoint files are off; torch takes M2H_TEST_THREADS threads (1).

    python tests/_torch_ddppo_rank.py OUT.pt --run-type train --exp-config ... [opts]

Test hooks, from the environment:
  M2H_TEST_SYNC_STORE stop|go: the num-done store answers as if the whole
    world (stop) or no rank (go) were done, so the preemptive sync's store
    reads can differ between ranks;
  M2H_TEST_SIGNAL USR1|USR2: the process sends itself that signal at the
    end of its first training cycle (or pretrain epoch);
  M2H_TEST_PASSIVE_POINTS n: the pretrain's synthetic sources hold n train
    and n / 2 validation datapoints;
  M2H_TEST_FLOAT64 1: the pretrain's weights (and so its U-Nets) are
    float64, on the float32 render; RL training's policy computes in
    float64 (its weights, Adam state and refit slabs float64) on the
    float32 render, its separator masks rounded to float32 where
    masked_mix_slice16 reads them (the plain version does so on the CPU,
    the CUDA kernel takes a float32 mask).

Imported by the tests: ``launch``, ``launch_world`` and ``finish`` start
and wait for such processes (each wait bounded, a hung rank killed),
``train_argv`` builds a tiny CPU run's arguments, and ``run_in_world``
runs one of the small functions below on every rank of a spawned gloo
world.
"""

import os
import signal
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny training run of the JAX package's multi-process tests
# (tests/test_multihost.py): hidden 32, 2 steps, 1 update a cycle, RIR
# length 300, the synthetic micro-scene
TINY_TRAIN = [
    "NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1000", "LOG_INTERVAL", "1",
    "RL.PPO.hidden_size", "32", "RL.PPO.num_steps", "2", "RL.PPO.num_updates_per_cycle", "1",
    "RL.PPO.ppo_epoch", "1", "RL.PPO.num_mini_batch", "1", "RL.PPO.use_ddppo", "True",
    "RL.PPO.short_rollout_threshold", "1.0", "RL.PPO.pretrained_passive_separators_ckpt", "",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "4",
    "TASK_CONFIG.SIMULATOR.AUDIO.GT_MONO_MAG_NORM", "1.2", "TPU.MAX_RIR_LENGTH", "300",
    "RL.PPO.ddppo_distrib_backend", "GLOO",
]


def train_argv(model_dir, *opts, exp="configs/train/nearTarget.yaml"):
    """The main's arguments of a CPU training run with `exp` in
    `model_dir`, the config overrides `opts` after the tiny run's."""
    return ["--run-type", "train", "--exp-config", exp, "--model-dir", str(model_dir),
            "--device", "cpu", *(TINY_TRAIN if exp.startswith("configs/train/") else []),
            *opts]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out, argv, rank=None, world=None, port=None, env=None):
    """One process of this script; `rank`, `world` and `port` make it a rank
    of a gloo world on the loopback. Returns the Popen."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    if world is not None:
        e.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    e.update(env or {})
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out), *argv],
                            cwd=REPO, env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def launch_world(outs, argv, env=None, envs=None):
    """A world of len(outs) ranks (`envs`: extra variables by rank)."""
    port = free_port()
    return [launch(out, argv, r, len(outs), port, {**(env or {}), **((envs or {}).get(r, {}))})
            for r, out in enumerate(outs)]


def finish(procs, timeout=180):
    """Wait for every process (each at most `timeout` s, killed past it) and
    return their outputs; fail with the output of any that failed."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\nKILLED after {timeout} s"
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK-OK" in out, out[-4000:]
    return outs


class _FixedStore:
    def __init__(self, n):
        self._n = n

    def add(self, generation):
        return self._n

    def get(self, generation):
        return self._n

    def close(self):
        pass


def _install_hooks():
    sys.path.insert(0, REPO)
    import move2hear_tpu_torch.pretrain.trainer as pt
    import move2hear_tpu_torch.rl.trainer as rt
    from move2hear_tpu_torch.parallel.ddppo import RolloutSyncState
    from move2hear_tpu_torch.utils.tb import TensorboardWriter

    # no TensorBoard (importing it pulls TensorFlow where that is installed)
    # and no checkpoint files (each holds the U-Nets and their Adam state)
    rt.TensorboardWriter = pt.TensorboardWriter = lambda *a, **k: TensorboardWriter("")
    rt.PPOTrainer._save = pt.PassiveTrainer._save = lambda self, *a, **k: None

    mode = os.environ.get("M2H_TEST_SYNC_STORE", "")
    if mode:
        def make_sync(self, t_steps):
            p = self.config.RL.PPO
            ranks = self._world()[1]
            return RolloutSyncState(p.sync_frac, p.short_rollout_threshold, t_steps, ranks,
                                    store=_FixedStore(10**6 if mode == "stop" else 0))

        rt.PPOTrainer._make_rollout_sync = make_sync

    points = int(os.environ.get("M2H_TEST_PASSIVE_POINTS", "0"))
    if points:
        from move2hear_tpu_torch.pretrain.dataset import SyntheticPassiveSource

        pt.PassiveTrainer._default_sources = lambda self: {
            "train": SyntheticPassiveSource(num_datapoints=points, seed=0),
            "val": SyntheticPassiveSource(num_datapoints=points // 2, seed=1),
            "nonoverlapping_val": SyntheticPassiveSource(num_datapoints=points // 2, seed=2),
        }

    if os.environ.get("M2H_TEST_FLOAT64"):
        import torch

        import move2hear_tpu_torch.models.audio_cnn as audio_cnn
        import move2hear_tpu_torch.models.unet as unet

        new_policy = pt.PassiveTrainer.new_policy
        pt.PassiveTrainer.new_policy = lambda self: new_policy(self).double()
        tpu_dtype = rt.tpu_dtype

        def float64_dtype(tpu, key):
            dt = tpu_dtype(tpu, key)
            return torch.float64 if key in ("COMPUTE_DTYPE", "SEP_SLAB_DTYPE") else dt

        rt.tpu_dtype = float64_dtype
        new_rl_policy = rt.PPOTrainer._new_policy
        rt.PPOTrainer._new_policy = lambda self: new_rl_policy(self).double()
        kernel = audio_cnn.masked_mix_slice16

        def float32_mask(mix, mask):
            return kernel(mix, mask.to(mix.dtype))

        audio_cnn.masked_mix_slice16 = unet.masked_mix_slice16 = float32_mask

    sig = os.environ.get("M2H_TEST_SIGNAL", "")
    if sig:
        signum = getattr(signal, "SIG" + sig)
        fired = []

        def once():
            if not fired:
                fired.append(True)
                os.kill(os.getpid(), signum)

        check = rt.PPOTrainer._check_preemption

        def check_after_signal(self, *args, **kwargs):
            once()
            return check(self, *args, **kwargs)

        rt.PPOTrainer._check_preemption = check_after_signal
        val_losses = pt.PassiveTrainer._val_losses

        def val_then_signal(self, *args, **kwargs):
            out = val_losses(self, *args, **kwargs)
            once()
            return out

        pt.PassiveTrainer._val_losses = val_then_signal


def assert_world_equals_single(ranks, single):
    """Every rank's parameters bitwise equal to rank 0's, and rank 0's and
    its losses within rtol 1e-4, atol 1e-5 of the single rank's."""
    import torch

    assert ranks[0]["state_dict"].keys() == single["state_dict"].keys()
    assert len(single["state_dict"]) > 10
    for k, v in ranks[0]["state_dict"].items():
        for other in ranks[1:]:
            assert torch.equal(v, other["state_dict"][k]), k  # the DDP weight-sync contract
        if v.is_floating_point():
            torch.testing.assert_close(v, single["state_dict"][k], rtol=1e-4, atol=1e-5,
                                       msg=k)
    for (pol, sep), (spol, ssep) in zip(ranks[0]["loss_log"], single["loss_log"]):
        torch.testing.assert_close(pol, spol, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(sep, ssep, rtol=1e-4, atol=1e-5)


# --- small functions run on every rank of a spawned gloo world ---------

def _world_worker(fn_name, rank, world, port, args, queue):
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        queue.put((rank, globals()[fn_name](rank, world, *args)))
    finally:
        dist.destroy_process_group()


def run_in_world(fn_name, world, *args, timeout=120):
    """[fn(rank, world, *args) for each rank] of a spawned gloo world on the
    CPU; `fn_name` names a function of this module."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_world_worker, args=(fn_name, r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [results[r] for r in range(world)]


def normalised_shard(rank, world, adv, w):
    """This rank's env columns of (T, N, 1) advantages, normalised over the
    world (with step weights `w`, (T, 1, 1), when given)."""
    import torch

    from move2hear_tpu_torch.rl.ppo import _world_normalized_advantages

    n = adv.shape[1] // world
    shard = torch.from_numpy(adv[:, rank * n: (rank + 1) * n])
    return _world_normalized_advantages(
        shard, None if w is None else torch.from_numpy(w), True).numpy()


def batchnorm_shard(rank, world, x, g):
    """BatchNorm2d in training mode on this rank's rows of `x` (float64):
    the output, the input's gradient of sum(out * g), the summed gradients
    of weight and bias, and the running statistics."""
    import torch

    from move2hear_tpu_torch.models.unet import BatchNorm2d
    from move2hear_tpu_torch.parallel.dist import all_reduce_

    b = x.shape[0] // world
    bn = BatchNorm2d(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    xs = torch.from_numpy(x[rank * b: (rank + 1) * b]).requires_grad_(True)
    out = bn(xs)
    (out * torch.from_numpy(g[rank * b: (rank + 1) * b])).sum().backward()
    wg = all_reduce_(torch.cat([bn.weight.grad, bn.bias.grad]))
    return (out.detach().numpy(), xs.grad.numpy(), wg.numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy())


def pretrain_refusal(rank, world, batch_size):
    """The pretrain's error for a batch the world does not divide, or None."""
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.pretrain.trainer import PassiveTrainer

    # the trainer's constructor writes nothing under the model dir
    cfg = get_config("configs/pretrain_passive.yaml",
                     ["Pretrain.Passive.BATCH_SIZE", str(batch_size)], "unwritten", "train")
    try:
        PassiveTrainer(cfg, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def store_generations(rank, world, port):
    """The generation-keyed num-done store on the TCPStore across the
    world: rank 0 finishes generation 1 while rank 1 still collects, then
    rank 1 enters generation 2; rank 0's mark for generation 1 stays.
    Returns what each rank read."""
    import torch.distributed as dist

    from move2hear_tpu_torch.parallel.ddppo import RolloutSyncState, make_num_done_store

    sync = RolloutSyncState(0.4, 0.25, 4, world,
                            store=make_num_done_store(rank, world, "127.0.0.1", port))
    sync.new_rollout()                       # generation 1 on every rank
    if rank == 0:
        sync.mark_done()
    dist.barrier()                           # rank 0's mark is posted
    reads = {"gen1_before": sync.store.get(1), "stop_at_1": sync.should_stop_early(1)}
    if rank == 1:
        sync.mark_done()                     # rank 1 ends generation 1 late ...
        sync.new_rollout()                   # ... and enters generation 2
    dist.barrier()
    reads.update(gen1_after=sync.store.get(1), gen2=sync.store.get(2),
                 stop_at_4=sync.should_stop_early(4))
    dist.barrier()                           # rank 0 serves the store until all read
    return reads


def main():
    import torch

    torch.set_num_threads(int(os.environ.get("M2H_TEST_THREADS", "1")))
    out, *argv = sys.argv[1:]
    _install_hooks()
    from move2hear_tpu_torch.main import main as port_main

    trainer = port_main(argv)
    torch.save({
        "state_dict": {k: v.detach().cpu() for k, v in trainer.final_policy.state_dict().items()},
        "loss_log": [tuple(torch.as_tensor(x) for x in pair)
                     for pair in getattr(trainer, "loss_log", [])],
        "val_history": getattr(trainer, "_val_history", None),
        "sep_fill": getattr(trainer, "_last_sep_fill", None),
        "cycles": len(getattr(trainer, "cycle_log", []) or []),
        "mfu_info": getattr(trainer, "mfu_info", None),
    }, out)
    print("RANK-OK", os.environ.get("RANK", "0"), flush=True)


if __name__ == "__main__":
    main()

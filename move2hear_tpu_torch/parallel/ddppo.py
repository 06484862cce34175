"""DDPPO's control plane (the reference's ``rl/ppo/ddppo_utils.py``; the JAX
package's ``parallel/ddppo.py``) on ``torch.distributed``:

- rank and world discovery from torchrun's or SLURM's variables
  (ddppo_utils.py:142-155), and ``init_distributed`` through
  ``torch.distributed.init_process_group`` (nccl or gloo, from
  ``RL.PPO.ddppo_distrib_backend``) when the world holds more than one rank;
- the preemptive rollout sync's num-done counter (the reference's TCPStore
  on ``master_port + 1``, ppo_trainer.py:597-600, 769-782), keyed by rollout
  generation;
- the preemption signals, ``requeue_job`` and the interrupted state
  (ddppo_utils.py:26-110), keyed by job id and experiment scope.

The collectives the trainers call live in ``parallel/dist.py``.
"""

import hashlib
import logging
import os
import pickle
import signal
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch.distributed as dist

logger = logging.getLogger(__name__)

EXIT = threading.Event()
REQUEUE = threading.Event()

BACKENDS = {"NCCL": "nccl", "GLOO": "gloo"}


def add_signal_handlers(requeue_signal: int = signal.SIGUSR1) -> dict:
    """SIGINT, SIGTERM and SIGUSR2 set EXIT; SIGUSR1 sets EXIT and REQUEUE
    (ddppo_utils.py:43-56). Returns the handlers they replace, by signal."""

    def _clean_exit(*_):
        EXIT.set()

    def _requeue(*_):
        EXIT.set()
        REQUEUE.set()

    previous = {}
    for s in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR2):
        previous[s] = signal.signal(s, _clean_exit)
    previous[requeue_signal] = signal.signal(requeue_signal, _requeue)
    return previous


def get_distrib_info():
    """(local_rank, world_rank, world_size) from torchrun's variables, else
    SLURM's, else the single-process (0, 0, 1) (ddppo_utils.py:142-155)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return (int(os.environ.get("LOCAL_RANK", 0)), int(os.environ["RANK"]),
                int(os.environ["WORLD_SIZE"]))
    if "SLURM_PROCID" in os.environ:
        return (int(os.environ["SLURM_LOCALID"]), int(os.environ["SLURM_PROCID"]),
                int(os.environ["SLURM_NTASKS"]))
    return 0, 0, 1


def torch_backend(name: str) -> str:
    """The torch.distributed backend of ``RL.PPO.ddppo_distrib_backend``:
    NCCL or GLOO; any other value raises."""
    key = str(name).upper()
    if key not in BACKENDS:
        raise ValueError(
            f"RL.PPO.ddppo_distrib_backend={name!r}: the port's backends are NCCL "
            "(one rank per GPU) and GLOO"
        )
    return BACKENDS[key]


def master_address(master_addr: str = "127.0.0.1", master_port: int = 8738):
    """(address, port) of the rendezvous: MASTER_ADDR and MASTER_PORT
    override the config's values."""
    return (os.environ.get("MASTER_ADDR", master_addr),
            int(os.environ.get("MASTER_PORT", master_port)))


def init_distributed(backend: str = "NCCL", master_addr: str = "127.0.0.1",
                     master_port: int = 8738):
    """Join the process group when the world holds more than one rank; a
    world of one initialises nothing. Returns (local_rank, world_rank,
    world_size). The backend is the config's, never a fallback: a failed
    init raises."""
    name = torch_backend(backend)
    local_rank, world_rank, world_size = get_distrib_info()
    if world_size > 1 and not dist.is_initialized():
        addr, port = master_address(master_addr, master_port)
        dist.init_process_group(name, init_method=f"tcp://{addr}:{port}",
                                world_size=world_size, rank=world_rank)
        logger.info("rank %d of %d joined %s at %s:%d", world_rank, world_size, name,
                    addr, port)
    return local_rank, world_rank, world_size


# --- num-done store ------------------------------------------------------

class NumDoneStore:
    """Counter of ranks that finished their rollout: the preemptive sync
    stops collecting once the count exceeds ``sync_frac * world_size`` past
    ``short_rollout_threshold * num_steps`` (ppo_trainer.py:769-782).

    Generation-keyed: one counter per rollout generation, and no shared
    reset (a reset at rollout start lets a slow rank erase the marks that
    faster ranks already posted for the current rollout)."""

    def add(self, generation: int) -> int:
        """Mark this rank done for `generation`; return its count."""
        raise NotImplementedError

    def get(self, generation: int) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalNumDoneStore(NumDoneStore):
    """A world of one's in-process counter."""

    def __init__(self):
        self._counts = {}
        self._lock = threading.Lock()

    def add(self, generation):
        with self._lock:
            self._counts[generation] = self._counts.get(generation, 0) + 1
            return self._counts[generation]

    def get(self, generation):
        return self._counts.get(generation, 0)


class TCPNumDoneStore(NumDoneStore):
    """``torch.distributed.TCPStore`` served by rank 0, one key a
    generation; ``add(key, 0)`` reads a count without waiting for the key."""

    def __init__(self, addr: str, port: int, is_master: bool, world_size: int,
                 timeout_s: float = 300.0):
        from datetime import timedelta

        self._store = dist.TCPStore(addr, port, world_size, is_master,
                                    timedelta(seconds=timeout_s))

    def add(self, generation):
        return int(self._store.add(f"num_done_{int(generation)}", 1))

    def get(self, generation):
        return int(self._store.add(f"num_done_{int(generation)}", 0))


def make_num_done_store(world_rank: int, world_size: int, master_addr: str = "127.0.0.1",
                        master_port: int = 8738) -> NumDoneStore:
    """A world of one counts in-process; a larger world through the TCPStore
    on ``master_port + 1`` (ppo_trainer.py:597-600)."""
    if world_size <= 1:
        return LocalNumDoneStore()
    addr, port = master_address(master_addr, master_port)
    return TCPNumDoneStore(addr, port + 1, world_rank == 0, world_size)


@dataclass
class RolloutSyncState:
    """The preemptive sync's policy inside the rollout loop. Each rank moves
    its own generation on at rollout start: all ranks run the same sequence
    of rollouts, so their generations agree without a shared reset."""

    sync_frac: float
    short_rollout_threshold: float
    num_steps: int
    world_size: int
    store: NumDoneStore = field(default_factory=LocalNumDoneStore)
    generation: int = 0

    def should_stop_early(self, step: int) -> bool:
        if self.world_size <= 1:
            return False
        return (step >= self.short_rollout_threshold * self.num_steps
                and self.store.get(self.generation) > self.sync_frac * self.world_size)

    def mark_done(self) -> None:
        self.store.add(self.generation)

    def new_rollout(self) -> None:
        self.generation += 1


def requeue_job() -> bool:
    """Requeue the SLURM job after a SIGUSR1 (ddppo_utils.py:98-110): rank 0
    calls ``scontrol requeue``; True when the job is to be requeued."""
    import subprocess

    if not REQUEUE.is_set():
        return False
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id is None:
        return False
    if get_distrib_info()[1] == 0:
        logger.info("requeueing SLURM job %s", job_id)
        try:
            subprocess.run(["scontrol", "requeue", job_id], check=False)
        except FileNotFoundError:
            logger.warning("requeue: no scontrol on this host")
    return True


# --- interrupted state ---------------------------------------------------

def interrupted_state_path(job_id, scope: str = "") -> str:
    """The preemption snapshot's path, the JAX package's string: under
    INTERRUPTED_STATE_DIR (default ~/.interrupted_states), named by the job
    id and, where `scope` (trainer kind and checkpoint folder) is given, the
    first 12 hex digits of its SHA-1, so runs that share the default job id
    do not adopt each other's state."""
    base = os.environ.get("INTERRUPTED_STATE_DIR",
                          os.path.join(os.path.expanduser("~"), ".interrupted_states"))
    name = str(job_id)
    if scope:
        name += "-" + hashlib.sha1(scope.encode()).hexdigest()[:12]
    return os.path.join(base, f"{name}.ckpt")


def save_interrupted_state(state: dict, job_id, scope: str = "") -> str:
    from move2hear_tpu_torch.utils.checkpoint import save_checkpoint

    path = interrupted_state_path(job_id, scope)
    save_checkpoint(path, state)
    return path


def load_interrupted_state(job_id, scope: str = "") -> Optional[dict]:
    """The snapshot, or None when there is none or the port cannot read it
    (a JAX-package snapshot under the same scope, a partial file): that
    file is ignored with a warning."""
    from move2hear_tpu_torch.utils.checkpoint import load_checkpoint

    path = interrupted_state_path(job_id, scope)
    if not os.path.exists(path):
        return None
    try:
        state = load_checkpoint(path)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        logger.warning("ignoring interrupted state %s: the port cannot read it (%s)", path,
                       type(e).__name__)
        return None
    if not isinstance(state, dict) or "extra_state" not in state:
        logger.warning("ignoring interrupted state %s: not a snapshot of the port", path)
        return None
    return state


def clear_interrupted_state(job_id, scope: str = "") -> None:
    """Remove the snapshot after a run that ended normally; nothing when the
    run ends because of a preemption signal, or on a rank other than 0."""
    if EXIT.is_set() or get_distrib_info()[1] != 0:
        return
    path = interrupted_state_path(job_id, scope)
    try:
        os.remove(path)
    except FileNotFoundError:
        pass

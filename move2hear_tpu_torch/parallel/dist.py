"""The collectives of data-parallel training (the counterpart of the JAX
package's ``parallel/mesh.py``, whose psum and pmean XLA inserts into the
sharded programs): plain functions on tensors over the default process
group. With a world of one each is the identity and launches nothing.

They are written by hand rather than taken from ``DistributedDataParallel``:
DDP hooks ``forward``, while the PPO update calls ``evaluate_actions``, the
pose-bank encoder and the separator refit outside it.

``COMM`` counts the calls, the bytes reduced and the host seconds spent in
them. Under gloo with CUDA tensors the call waits for the kernels that
produce its input, so the timer waits for them first, and reads only the
collective; under nccl a call returns once it is queued, and the seconds
are those of queueing it.
"""

import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COMM = {"calls": 0, "bytes": 0, "seconds": 0.0}


def world() -> Tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return world()[1]


def _gloo() -> bool:
    return dist.get_backend() == "gloo"


def _timed(fn, tensor: torch.Tensor):
    if tensor.is_cuda and _gloo():
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    out = fn()
    COMM["calls"] += 1
    COMM["bytes"] += tensor.numel() * tensor.element_size()
    COMM["seconds"] += time.perf_counter() - t0
    return out


def _flag_device() -> torch.device:
    """Where a control-plane scalar lives: the current GPU under nccl, the
    CPU under gloo."""
    if _gloo():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src`."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            _timed(lambda t=t: dist.broadcast(t.data, src), t)


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the world, in place."""
    if world_size() > 1:
        _timed(lambda: dist.all_reduce(tensor), tensor)
    return tensor


def all_reduce_grads(params: Sequence[torch.nn.Parameter],
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum the gradients of `params` over the world in one flat all-reduce
    (each rank's loss is its share of the global mean, so the sum is the
    global gradient), with the float32 `extra` (the step's logged losses)
    riding in the same buffer; returns `extra` summed. Call it before the
    gradient clip, where the JAX update's psum sits."""
    if world_size() == 1:
        return extra
    grads = [p.grad for p in params]
    parts = [g.reshape(-1) for g in grads] + ([] if extra is None else [extra.reshape(-1)])
    flat = torch.cat(parts)
    all_reduce_(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()
    return None if extra is None else flat[off:].view_as(extra)


def distributed_mean_var(x: torch.Tensor, w: Optional[torch.Tensor] = None):
    """(mean, unbiased variance) of `x` over the world's elements, those of
    weight `w` (broadcast to x) only when given: the sums of the weights and
    of x go in one all-reduce, the squared deviations from the global mean
    in a second. A world of one with no weights gives ``x.mean()`` and
    ``x.var()``."""
    if w is None and world_size() == 1:
        return x.mean(), x.var()
    w = torch.ones_like(x) if w is None else torch.broadcast_to(w, x.shape).to(x.dtype)
    sums = all_reduce_(torch.stack([w.sum(), (x * w).sum()]))
    wsum = sums[0]
    mean = sums[1] / torch.clamp(wsum, min=1.0)
    vsum = all_reduce_((torch.square(x - mean) * w).sum().reshape(1))[0]
    return mean, vsum / torch.clamp(wsum - 1.0, min=1.0)


def collective_any(flag: bool) -> bool:
    """True on every rank iff any rank passed True. Host decisions from
    out-of-band state (a store read, a signal that reached one rank) can
    differ between ranks by timing alone; acting on a divergent one would
    leave a rank waiting in a collective the others never enter."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=_flag_device())
    _timed(lambda: dist.all_reduce(t, op=dist.ReduceOp.MAX), t)
    return bool(t.item())


def gather_to_rank0(tensor: torch.Tensor, dim: int = 0) -> Optional[torch.Tensor]:
    """The ranks' `tensor`s concatenated along `dim` in rank order on rank
    0 (on the CPU under gloo), None on the other ranks; `tensor` itself in a
    world of one. Every rank's tensor has the same shape."""
    rank, size = world()
    if size == 1:
        return tensor
    t = tensor.contiguous()
    if _gloo():
        t = t.cpu()
    parts: Optional[List[torch.Tensor]] = (
        [torch.empty_like(t) for _ in range(size)] if rank == 0 else None
    )
    _timed(lambda: dist.gather(t, parts, dst=0), t)
    return torch.cat(parts, dim=dim) if rank == 0 else None

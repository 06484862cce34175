"""ctypes binding of the native graph walker (``m2h_native.cc``): BFS
geodesics cached per source, the Move2Hear forward rule, and a batched
geodesic lookup.

At first use the source is compiled by the host compiler (``$CXX``, split
as a shell would, else ``g++``; ``CXX_FLAGS``) into a shared library under
``move2hear_tpu_torch/_build/`` (listed in ``.gitignore``), whose name
carries a hash of the source, the compiler and the flags
(``ops/build.py:hashed_library``), so an edited source or another compiler
never loads a stale binary. A failed build raises with the compiler's
output: there is no fallback. Nothing is built at import time.

The library is loaded as a ``ctypes.PyDLL``, which holds the interpreter
lock through every call: the walker caches BFS rows in the graph and is
not thread-safe, so no two threads of a process may run in it at once.

A ``NativeGraph`` owns one C++ graph and frees it once, in ``close`` or
when collected, and only in the process that made it: a forked child (the
host env workers, ``env/vector_env.py``) works on its own copy of the
parent's memory and leaves the handle alone. A graph cannot be pickled: its
handle means nothing in another process.
"""

import ctypes
import os
import shlex
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from move2hear_tpu_torch.ops.build import hashed_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "m2h_native.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.PyDLL] = {}
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def compiler() -> List[str]:
    """The host compiler's command: ``$CXX`` split as a shell would, else
    ``g++``."""
    return shlex.split(os.environ.get("CXX") or "g++")


def library_path() -> str:
    return hashed_library("m2h_native", SOURCE, (*compiler(), *CXX_FLAGS))


def build() -> Tuple[str, float]:
    """Compile the library if it is not built yet. Returns its path and the
    wall seconds the compile took (0.0 if it was built); raises
    RuntimeError with the compiler's output if the compile fails."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path[:-3]}.{os.getpid()}.tmp.so"
    cmd = [*compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(
            f"the native graph walker cannot be built: {shlex.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"the native graph walker failed to build (rc {proc.returncode}): "
                           f"{shlex.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path, time.perf_counter() - t0


def load() -> ctypes.PyDLL:
    """The walker's library, built at first use, with every function's
    argtypes and restype set."""
    with _LOCK:
        path, _ = build()
        lib = _LIBS.get(path)
        if lib is None:
            lib = ctypes.PyDLL(path)
            lib.m2h_graph_create.restype = ctypes.c_void_p
            lib.m2h_graph_create.argtypes = [ctypes.c_int32, _F64, _I32, _I32]
            lib.m2h_graph_destroy.restype = None
            lib.m2h_graph_destroy.argtypes = [ctypes.c_void_p]
            for fn in (lib.m2h_shortest_path_steps, lib.m2h_forward_neighbor):
                fn.restype = ctypes.c_int32
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
            lib.m2h_geodesic_batch.restype = None
            lib.m2h_geodesic_batch.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32, _I32, _I32]
            _LIBS[path] = lib
        return lib


class NativeGraph:
    """One scene graph in the walker: node positions (V, 3) and each node's
    neighbours in adjacency order."""

    def __init__(self, positions: np.ndarray, neighbors: Sequence[Sequence[int]]):
        pos = np.ascontiguousarray(positions, np.float64)
        n = len(pos)
        if pos.shape != (n, 3) or len(neighbors) != n:
            raise ValueError(f"positions {pos.shape} and {len(neighbors)} adjacency lists do "
                             "not describe one graph of (V, 3) positions")
        adj_off = np.zeros(n + 1, np.int32)
        adj_off[1:] = np.cumsum([len(ns) for ns in neighbors])
        adj = np.fromiter((v for ns in neighbors for v in ns), np.int64, int(adj_off[-1]))
        if adj.size and (adj.min() < 0 or adj.max() >= n):
            raise ValueError(f"an adjacency list names a node outside [0, {n})")
        adj = adj.astype(np.int32)
        self.num_nodes = n
        self._lib = load()
        self._pid = os.getpid()
        self._handle = self._lib.m2h_graph_create(n, pos, adj, adj_off)

    def close(self) -> None:
        """Free the graph; in a process forked after it was made, only drop
        the handle."""
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and self._pid == os.getpid():
            self._lib.m2h_graph_destroy(handle)

    def __del__(self):
        self.close()

    def __reduce__(self):
        raise TypeError("a NativeGraph holds a C++ handle of this process and cannot be pickled")

    def _check(self, node: int) -> None:
        if self._handle is None:
            raise ValueError("the NativeGraph is closed")
        if not 0 <= node < self.num_nodes:
            raise IndexError(f"node {node} outside [0, {self.num_nodes})")

    def shortest_path_steps(self, a: int, b: int) -> int:
        """Steps from `a` to `b`, -1 where unreachable or out of range."""
        if self._handle is None:
            raise ValueError("the NativeGraph is closed")
        return int(self._lib.m2h_shortest_path_steps(self._handle, a, b))

    def forward_neighbor(self, node: int, orientation: int) -> int:
        self._check(node)
        return int(self._lib.m2h_forward_neighbor(self._handle, node, orientation))

    def geodesic_batch(self, a, b) -> np.ndarray:
        """Steps from a[i] to b[i] for every i, int32, -1 where unreachable."""
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.ndim != 1:
            raise ValueError(f"geodesic_batch takes two equal 1-D index arrays, not {a.shape} "
                             f"and {b.shape}")
        out = np.zeros(len(a), np.int32)
        if len(a):
            self._check(int(min(a.min(), b.min())))
            self._check(int(max(a.max(), b.max())))
            self._lib.m2h_geodesic_batch(self._handle, len(a), np.ascontiguousarray(a, np.int32),
                                         np.ascontiguousarray(b, np.int32), out)
        return out

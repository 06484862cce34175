"""Builds the hand-written CUDA kernels under ``csrc/`` and binds them.

Each ``csrc/<name>.cu`` exports plain C launchers (``<name>_launch``, and
for a variant ``<variant>_launch``) that take device pointers, sizes and a
stream and return the launch's ``cudaGetLastError``. At first use every source is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``_build/`` (listed in
``.gitignore``), one ``nvcc`` per source and all started together, and the
library is loaded with ``ctypes``. Library names carry a hash of the source
and the flags, so an edited source is rebuilt and never loads a stale
binary. Nothing here runs at import time: the CPU tests import every module
on machines without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each kernel's launcher; the stream is the last argument
SIGNATURES = {
    # mix, mask, out, B, F, T, C, K
    "masked_mix_slice16": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same with a bfloat16 mask
    "masked_mix_slice16_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # g, mix, mask, dmix, dmask, B, F, T, C, K
    "masked_mix_slice16_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same with a bfloat16 mask
    "masked_mix_slice16_bwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # frames, win, inv_env, out, B, n_frames, n_fft, hop, start, length
    "overlap_add": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # blocks, threads: the launch floor chip_smoke.py measures, on no path
    "empty": (_I, _I, _P),
}

# the source of a launcher that is a variant in another kernel's file
VARIANT_OF = {
    "masked_mix_slice16_bf16": "masked_mix_slice16",
    "masked_mix_slice16_bwd_bf16": "masked_mix_slice16_bwd",
}
# the csrc/ sources, one library each
SOURCES = tuple(n for n in SIGNATURES if n not in VARIANT_OF)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> nvcc/ptxas output of its last build in this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built"
        )
    return path


def hashed_library(stem: str, src: str, command: Sequence[str]) -> str:
    """``_build/lib<stem>-<hash>.so`` for the source `src` compiled by
    `command` (compiler and flags): the hash covers both."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(command).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def library_path(name: str) -> str:
    return hashed_library(name, os.path.join(CSRC_DIR, name + ".cu"), NVCC_FLAGS)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every library of the sources `names` not built yet, all in
    parallel. Returns the wall seconds spent; raises with nvcc's output if
    any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        lib = library_path(name)
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        src = os.path.join(CSRC_DIR, name + ".cu")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            lib,
        )
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        else:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of launcher `name` (a kernel or a variant),
    building all kernels at first use. Its launcher's argtypes and restype
    are set."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(library_path(VARIANT_OF.get(name, name)))
            fn = getattr(lib, name + "_launch")
            fn.argtypes = list(SIGNATURES[name])
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib

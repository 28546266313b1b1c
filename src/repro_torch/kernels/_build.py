"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``
(the ``csrc/*.cuh`` headers they include are hashed with them),
all of them at once, and the objects are linked into one shared library with
a plain C interface, at first use, and loaded with ``ctypes``.  The library
lands in ``build/repro_torch/`` at the root of the checkout (git-ignored),
named by a hash of the sources and the compiler flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import time: the CPU tests import every module of the package on machines
that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "build_seconds", "build_log", "library_path", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_build_seconds: "float | None" = None
_build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signatures of the entry points (every pointer and the stream as void*)
_SIGNATURES = {
    "parzen_score_workspace": (None, [_I, _I, _I, _I, _P]),
    "parzen_score_launch": (
        _I, [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _L, _P, _L, _P, _P],
    ),
    "mc_hv_counts_launch": (_I, [_P, _I, _P, _I, _I, _P, _P, _P]),
    "mc_hv_counts_sets_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]),
    "mc_hv_samples_launch": (_I, [_P, _P, _P, _I, _I, _I, _P, _P]),
    "flash_attention_launch": (
        _I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _F, _I, _I, _F, _P],
    ),
    "flash_attention_smem_bytes": (_I, [_I, _I]),
    "crossentropy_launch": (
        _I, [_P, _I, _L, _L, _P, _I, _L, _L, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    ),
    "crossentropy_splits": (_I, [_I, _I, _I]),
    "ssd_launch": (
        _I, [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _P],
    ),
    "ssd_smem_bytes": (_I, [_I, _I, _I, _I]),
    "slstm_plan": (_I, [_I, _I, _I, _I, _P]),
    "slstm_launch": (
        _I, [_P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _P],
    ),
}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], target: Path) -> None:
    global _build_log
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objs = [target.parent / f"{tag}.{src.stem}.o" for src in sources]
    tmp = target.parent / f"{tag}.tmp"
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, log) for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if not failed:
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        if proc.returncode:
            failed.append((link, proc.returncode, proc.stdout))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    _build_log = "".join(logs)  # ptxas: registers, shared memory, spills
    os.replace(tmp, target)  # atomic: a concurrent process never loads half a file


def library_path() -> Path:
    """Where the shared library of the current sources is (or will be) built."""
    return BUILD_DIR / f"libkernels-{_digest()}.so"


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            sources = _sources()
            target = library_path()
            if not target.exists():
                _compile(sources, target)
            lib = ctypes.CDLL(str(target))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _build_seconds = time.perf_counter() - t0
            _lib = lib
    return _lib


def build_seconds() -> "float | None":
    """Seconds the first :func:`load` took (compile included when it built)."""
    return _build_seconds


def build_log() -> str:
    """What ``nvcc`` printed when this process built the library ("" if it
    loaded an existing one)."""
    return _build_log

"""Engine policy of the PyTorch port: which path runs a hot reduction.

The sampler stack (``core/samplers/tpe.py``) and the multi-objective engine
(``core/moo.py``) dispatch every hot reduction through :func:`resolve_engine`:

* ``"numpy"`` — the float64 host path, bit-identical to the reference
  package's numpy engine;
* ``"torch"`` — the plain PyTorch version (``kernels/ref.py``), float32, on
  whatever device its tensors live on;
* ``"cuda"`` — the hand-written kernels (``kernels/parzen.py``,
  ``kernels/hypervolume.py``), float32, on a CUDA device only;
* ``"auto"`` — numpy below a work threshold (device dispatch costs more than
  it saves there), above it ``"cuda"`` on a CUDA device or ``"torch"`` when
  the caller asked for ``device="cpu"``.

The multi-objective dominance compare has no kernel: under both device
engines it is one torch compare on the float64 values (``core/moo.py``).
The model's kernels (``kernels/flash_attention.py``,
``kernels/crossentropy.py``, ``kernels/ssd.py``) take the model's engines
instead (``models/layers.py::ENGINES``: ``"auto"``, ``"cuda"``,
``"torch"``), under the same rule.

There is no environment opt-in and no probe that downgrades a requested
engine: an engine that cannot run raises.  Device inputs are padded to
power-of-two buckets (:func:`pad_pow2_vec` / :func:`pad_pow2_rows`) so a
kernel sees O(log n) distinct shapes as the history grows.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = [
    "ENGINES",
    "MIN_PAD",
    "TPE_JIT_THRESHOLD",
    "DOM_JIT_THRESHOLD",
    "DOM_CPU_CEILING",
    "SCORE_TABLE_SIZE",
    "validate_engine",
    "resolve_engine",
    "resolve_device",
    "pad_pow2_len",
    "pad_pow2_vec",
    "pad_pow2_rows",
    "full_float32_matmul",
    "OP_NAMESPACE",
    "kernel_op",
    "flop_formula",
]

#: guards the process-global TF32 flag around :func:`full_float32_matmul`
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 products on the card in full precision inside the block (or
    the decorated function), the caller's TF32 setting put back after.
    TF32 keeps about three decimal digits: too few where a product is held
    against a kernel's float32 result (a logsumexp, a recomputed softmax).
    The flag is process-global, so it is set under a lock."""
    with _TF32_LOCK:
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32

# -- the kernels as custom ops ---------------------------------------------------
#
# Each kernel's launch is a ``torch.library.custom_op`` with a fake
# implementation (its outputs' shapes and dtypes) and a FLOP formula
# (``torch.utils.flop_counter``), so a step runs on fake tensors in a world of
# fake ranks (``launch/dryrun.py``) and ``launch/op_analysis.py`` counts the
# kernels' work as it counts aten ops'.  The op is registered for CUDA only:
# CPU tensors take the plain version in the wrapper and never reach it.

#: the ops' namespace, ``torch.ops.repro_torch``: the package's own name, so a
#: copy imported under another name (``scripts/kernel_baseline.py``) registers
#: ops of its own
OP_NAMESPACE = __name__.split(".")[0]


def kernel_op(name: str):
    """Decorator: ``torch.library.custom_op`` ``<OP_NAMESPACE>::<name>``
    with a CUDA implementation only.  No kernel writes an input in place
    (every output is allocated by the launch), so ``mutates_args`` is empty."""
    return torch.library.custom_op(f"{OP_NAMESPACE}::{name}", mutates_args=(),
                                   device_types="cuda")


def flop_formula(name: str):
    """Decorator: the FLOP formula of the op ``name`` (called with the
    inputs' shapes in place of tensors, as ``torch.utils.flop_counter``
    calls its own)."""
    from torch.utils.flop_counter import register_flop_formula

    return register_flop_formula(getattr(getattr(torch.ops, OP_NAMESPACE), name))


# -- pow2 padding ---------------------------------------------------------------

#: smallest padded bucket — below this every input shares one shape
MIN_PAD = 8


def pad_pow2_len(n: int, min_pad: int = MIN_PAD) -> int:
    """Next power-of-two bucket >= ``n`` (floored at ``min_pad``)."""
    size = min_pad
    while size < n:
        size *= 2
    return size


def pad_pow2_vec(vec: np.ndarray, fill: float, min_pad: int = MIN_PAD) -> np.ndarray:
    """Pad a 1-D array to its power-of-two bucket with ``fill``.

    Device mixtures pad with ``log_norm = -inf``: padding components
    contribute ``exp(-inf) = 0`` to the logsumexp row sums (the kernel clamps
    each exponent at ``-1e30`` first), so the score is exactly the unpadded
    one while the shape only changes at power-of-two crossings."""
    n = len(vec)
    size = pad_pow2_len(n, min_pad)
    if size == n:
        return vec
    out = np.full(size, fill, dtype=vec.dtype if vec.dtype.kind == "f" else float)
    out[:n] = vec
    return out


def pad_pow2_rows(arr2d: np.ndarray, fill: float, min_pad: int = MIN_PAD) -> np.ndarray:
    """Pad a ``(n, d)`` array to a power-of-two row count with ``fill``."""
    n = len(arr2d)
    size = pad_pow2_len(n, min_pad)
    if size == n:
        return arr2d
    out = np.full((size, arr2d.shape[1]), fill)
    out[:n] = arr2d
    return out


# -- engine resolution ------------------------------------------------------------

ENGINES = ("auto", "numpy", "torch", "cuda")

#: auto-engine work thresholds: below these the numpy path wins outright
#: (device dispatch overhead dominates).  TPE work = n_candidates x
#: n_components (both estimators); dominance work = n_rows x n_objectives;
#: Monte-Carlo hypervolume work = n_points x n_samples.
TPE_JIT_THRESHOLD = 16384
DOM_JIT_THRESHOLD = 4096
#: on a CPU device, ``"auto"`` dominance goes back to numpy past this much
#: work, as the reference package does off its accelerator (the broadcast
#: compare would hold a large (n, n) working set in host memory); the card
#: has no ceiling.
DOM_CPU_CEILING = 64 * 1024
#: grid resolution of the TPE device score table (see samplers/tpe.py)
SCORE_TABLE_SIZE = 4096


def validate_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return engine


def resolve_device(engine: str, device=None):
    """The ``torch.device`` a sampler with ``engine`` scores on.

    ``device=None`` means the card (``cuda``).  Every engine but ``"numpy"``
    needs a CUDA device unless the caller passed ``device="cpu"``;
    ``engine="cuda"`` needs one in any case.  Raises instead of falling back."""
    validate_engine(engine)
    dev = torch.device("cuda" if device is None else device)
    if engine == "numpy":
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"engine={engine!r} runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch version on the host, "
                "or engine='numpy'"
            )
    elif engine == "cuda":
        raise RuntimeError(
            f"engine='cuda' launches CUDA kernels and cannot run on device {dev}"
        )
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def resolve_engine(engine: str, work: int, threshold: int, device) -> str:
    """Resolve a requested engine to a concrete path for one call site.

    ``"numpy"``, ``"torch"`` and ``"cuda"`` pass through.  ``"auto"`` stays on
    numpy below ``threshold`` units of work and above it picks ``"cuda"`` on
    a CUDA ``device`` and ``"torch"`` on a CPU one."""
    validate_engine(engine)
    if engine != "auto":
        return engine
    if work < threshold:
        return "numpy"
    return "cuda" if device.type == "cuda" else "torch"

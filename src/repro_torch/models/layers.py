"""Shared layers + the parameter-spec machinery.

Every parameter is declared as a :class:`Spec` (shape, logical axes, init).
Spec trees (nested dicts of specs) give, with no weight allocation:

* the parameter count, and abstract parameters (meta-device tensors,
  :func:`spec_shapes`) for sharded init and ``launch/specs.py``,
* the logical axes (:func:`spec_logical`) that ``models/sharding.py`` maps
  to DTensor placements,
* the shapes and initialization of the model's tensors.

``cross_entropy_chunked``, the training loss, goes through the fused
cross-entropy kernel (``kernels/crossentropy.py``); under an active mesh
(``models/sharding.py``) it is the vocab-parallel loss of
``models/tensor_parallel.py``, the kernel on each rank's vocabulary shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch
import torch.nn.functional as F

from ..kernels.crossentropy import fused_crossentropy
from ..kernels.ref import crossentropy_ref
from .sharding import active

__all__ = [
    "ENGINES",
    "check_engine",
    "Spec",
    "spec_leaves",
    "spec_map",
    "spec_shapes",
    "spec_logical",
    "init_params",
    "init_tensor",
    "rms_norm",
    "rope",
    "apply_rope",
    "swiglu",
    "gelu_mlp",
    "softcap",
    "cross_entropy_chunked",
]

#: how the kernels of the model run: "auto", the kernel's wrapper (the kernel
#: on CUDA tensors, its plain version on CPU ones); "cuda", the kernel (CUDA
#: tensors only); "torch", the plain version (autograd runs through it)
ENGINES = ("auto", "cuda", "torch")


def check_engine(engine: str, device: torch.device) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "cuda" and device.type != "cuda":
        raise RuntimeError(f"engine='cuda' launches the CUDA kernel and cannot run on {device}")


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor."""

    shape: tuple
    logical: tuple
    init: str = "normal"  # normal | zeros | ones | embed
    std: float | None = None  # explicit stddev; default 1/sqrt(fan_in=shape[-2])

    def stacked(self, n: int) -> "Spec":
        """Prepend a stacked-layers dim (fan-in unchanged)."""
        std = self.std
        if std is None and self.init == "normal":
            std = self._default_std()
        return Spec((n, *self.shape), ("layers", *self.logical), self.init, std)

    def _default_std(self) -> float:
        # fan-in = product of all dims except the last (output) dim
        fan_in = max(1, math.prod(self.shape[:-1]))
        return 1.0 / math.sqrt(fan_in)


def spec_leaves(tree, path: tuple = ()) -> Iterator[tuple[tuple, Spec]]:
    """``(path, spec)`` for every leaf, dict keys in sorted order (the order
    of a flattened pytree)."""
    if isinstance(tree, Spec):
        yield path, tree
        return
    for key in sorted(tree):
        yield from spec_leaves(tree[key], (*path, key))


def spec_map(fn: Callable[[Spec], Any], tree) -> Any:
    if isinstance(tree, Spec):
        return fn(tree)
    return {key: spec_map(fn, sub) for key, sub in tree.items()}


def spec_shapes(tree, dtype) -> Any:
    """The tree with each spec replaced by a meta-device tensor of its shape
    in ``dtype`` (no storage is allocated)."""
    return spec_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), tree)


def spec_logical(tree) -> Any:
    """The tree with each spec replaced by its logical axes."""
    return spec_map(lambda s: s.logical, tree)


def init_tensor(s: Spec, generator: torch.Generator, device, shape=None) -> torch.Tensor:
    """One float32 parameter by the reference's rules: zeros / ones, or a
    normal draw times ``std`` (``1/sqrt(fan_in)`` by default, 0.02 for
    embeddings).  The draw is made on the generator's device and moved to
    ``device``.  ``shape`` (default ``s.shape``) draws a slice of the leaf
    with the leaf's ``std``: one layer of a stacked leaf."""
    device = torch.device(device)
    shape = s.shape if shape is None else tuple(shape)
    if s.init == "zeros":
        return torch.zeros(shape, device=device)
    if s.init == "ones":
        return torch.ones(shape, device=device)
    std = s.std
    if std is None:
        std = s._default_std() if s.init == "normal" else 0.02
    if s.init == "embed":
        std = 0.02 if s.std is None else s.std
    out = torch.randn(shape, generator=generator, device=generator.device)
    return out.mul_(std).to(device)


def init_params(tree, generator: torch.Generator, device) -> Any:
    """A tree of float32 tensors for a spec tree, drawn leaf by leaf in
    :func:`spec_leaves` order from ``generator``."""
    flat = {path: init_tensor(s, generator, device) for path, s in spec_leaves(tree)}

    def build(sub, path):
        if isinstance(sub, Spec):
            return flat[path]
        return {key: build(val, (*path, key)) for key, val in sub.items()}

    return build(tree, ())


# -- primitive layers -------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a ``(1 + scale)`` gain, returned in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10000.0) -> tuple:
    """Rotary embedding tables for given positions [..., S] -> (sin, cos) of
    shape [..., S, head_dim//2]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; sin/cos: [B, S, D/2] (or broadcastable).  The head is
    split in halves (not interleaved pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == x.dim() - 1:
        sin, cos = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w1, w3, w2, compute_dtype) -> torch.Tensor:
    h = x @ w1.to(compute_dtype)
    g = x @ w3.to(compute_dtype)
    return (F.silu(h) * g) @ w2.to(compute_dtype)


def gelu_mlp(x: torch.Tensor, w1, w2, compute_dtype) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = x @ w1.to(compute_dtype)
    return F.gelu(h, approximate="tanh") @ w2.to(compute_dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def cross_entropy_chunked(
    x: torch.Tensor,  # [B, S, D]
    w_out: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [B, S]
    *,
    chunk: int = 256,
    final_softcap: float | None = None,
    mask: torch.Tensor | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """Mean token cross-entropy ``sum(nll * mask) / max(sum(mask), 1)``
    without materializing [B, S, V] logits.

    The reference scans over sequence chunks of ``chunk`` tokens, each under
    ``jax.checkpoint``, so that its peak memory is O(B * chunk * V); the fused
    cross-entropy kernel never writes the logits, so here all B * S rows go
    through it at once and ``chunk`` keeps only the reference's ``S % chunk``
    contract.  ``w_out`` (the tied head a transposed view) is rounded to
    ``x``'s dtype, as the reference's ``w_out.astype(x.dtype)`` rounds it: a
    bfloat16 ``x``'s tensor-core kernel reads one bf16 cast of it a call in
    the same layout, a float32 ``x``'s kernel reads it in place.
    ``engine="torch"`` runs autograd through the plain version instead.
    Under an active mesh it is the vocab-parallel loss
    (``tensor_parallel.cross_entropy``)."""
    check_engine(engine, x.device)
    if active() is not None:
        from .tensor_parallel import cross_entropy

        return cross_entropy(x, w_out, labels, final_softcap=final_softcap, mask=mask,
                             engine=engine)
    B, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        raise AssertionError((S, chunk))
    xs = x.reshape(B * S, D)
    ls = labels.reshape(B * S)
    cap = final_softcap or 0.0
    if engine == "torch":
        nll = crossentropy_ref(xs, w_out, ls, cap)
    else:
        nll = fused_crossentropy(xs, w_out, ls, softcap=cap)
    if mask is None:
        return nll.sum() / max(B * S, 1)
    m = mask.reshape(B * S).to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)

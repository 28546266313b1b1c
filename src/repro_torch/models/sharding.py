"""Logical-axis sharding: every parameter/activation declares *logical* axes;
a rules table maps them to mesh axes, and the result becomes DTensor
placements (``torch.distributed.tensor``: a ``DeviceMesh`` with named dims,
``Shard(d)`` / ``Replicate()`` for each).  Divisibility is checked at apply
time — a logical axis whose size does not divide the assigned mesh axes
falls back to replication (e.g. kv_heads=4 on an 8-way "model" axis).

:func:`logical_to_spec` is the reference's rule and returns its
``PartitionSpec`` as a tuple (an entry is ``None``, a mesh axis name, or a
tuple of them); it reads the axis sizes from a ``DeviceMesh`` or from a
plain ``{name: size}`` map, so it runs without processes.
:func:`logical_to_sharding` turns the tuple into placements, one per mesh
dim; a tensor dim sharded over several mesh axes is split in mesh-dim order,
the first axis the major one, as the reference's spec tuple orders them.

The activation context (:class:`activation_sharding`, :func:`constrain`)
is the reference's: launchers activate a ``(mesh, rules)`` pair and the
model's anchors redistribute a DTensor activation to the rule's placements;
without an active pair, or on a plain tensor, they are the identity.  The
model's blocks read the pair (:func:`active`) to run on local shards
(``models/tensor_parallel.py``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "ShardingRules",
    "TRAIN_RULES",
    "SERVE_RULES",
    "logical_to_spec",
    "logical_to_sharding",
    "spec_to_placements",
    "tree_shardings",
    "axis_sizes",
    "dim_names",
    "mesh_device",
    "local_shard",
    "distribute",
    "distribute_params",
    "sharded_zeros",
    "with_logical_constraint",
    "activation_sharding",
    "active",
    "side_by_side",
    "side_by_side_layout",
    "carry_context",
    "constrain",
    "wrap_with_sharding_ctx",
]

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: dict

    def mesh_axes(self, logical: str | None) -> "tuple[str, ...]":
        if logical is None:
            return ()
        ax = self.rules.get(logical)
        if ax is None:
            return ()
        return (ax,) if isinstance(ax, str) else tuple(ax)


# Production rules. "pod" and "data" are both batch axes; "model" is the
# tensor/expert axis.  fsdp: weight 'embed' dims are additionally sharded over
# the batch axes for ZeRO-3-style memory scaling (GSPMD inserts the
# all-gathers).  Rules intentionally over-specify: missing mesh axes (e.g. no
# "pod" on the single-pod mesh) are filtered out at spec build time.
TRAIN_RULES = ShardingRules(
    rules={
        "batch": ("pod", "data"),
        # Megatron-style sequence parallelism: between layers, activations are
        # sharded over the model axis along seq; GSPMD all-gathers k/v inside
        # attention.  This divides the scan-over-layers residual stack (the
        # dominant train-memory term) by the TP degree.
        "seq": "model",
        "embed": None,
        "fsdp_embed": ("pod", "data"),  # weights' d_model dim under FSDP
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_group": None,
        "kv_lora": None,
        "conv": None,
        "state": None,
        "layers": None,
        "stage": "stage",  # only present on pipeline meshes
        "kv_seq": None,
    }
)

# Serving: no gradient/optimizer memory pressure -> keep weights replicated
# over the batch axes (fsdp off) to avoid per-step all-gathers; batch still
# over ("pod","data"); long-context decode shards the KV cache sequence dim
# over the batch axes (batch==1 cells).
SERVE_RULES = ShardingRules(
    rules={
        **TRAIN_RULES.rules,
        "seq": None,  # no residual stack to shard; keep activations whole
        "fsdp_embed": None,
        "kv_seq": ("pod", "data"),
        # caches whose head count does not divide the model axis (musicgen 24H,
        # gemma2 kv=8, tinyllama kv=4) shard the head_dim / MLA latent instead —
        # attention contracts these dims, GSPMD inserts the partial-sum
        # all-reduce (cheap at decode batch sizes).
        "head_dim": "model",
        "kv_lora": "model",
    }
)


def axis_sizes(mesh) -> dict:
    """``{mesh axis name: size}`` of a ``DeviceMesh`` or of such a map."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(
    logical: Sequence[str | None],
    shape: Sequence[int],
    mesh,
    rules: ShardingRules,
) -> tuple:
    """Build the reference's PartitionSpec (as a tuple), dropping mesh axes
    that are absent, already used, or do not divide the dimension."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    spec: list[Any] = []
    for dim, name in zip(shape, logical):
        axes = []
        for ax in rules.mesh_axes(name):
            if ax not in sizes or ax in used:
                continue
            group = math.prod(sizes[a] for a in axes)
            if dim % (group * sizes[ax]) != 0:
                continue
            axes.append(ax)
            used.add(ax)
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(tuple(axes))
    # trim trailing Nones
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def dim_names(mesh) -> tuple:
    return tuple(mesh) if isinstance(mesh, dict) else tuple(mesh.mesh_dim_names)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    spec entry names that mesh axis, ``Replicate()`` elsewhere."""
    names = dim_names(mesh)
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        for ax in axes:
            placements[names.index(ax)] = Shard(dim)
    return tuple(placements)


def logical_to_sharding(
    logical: Sequence[str | None],
    shape: Sequence[int],
    mesh,
    rules: ShardingRules,
) -> tuple:
    """The DTensor placements of :func:`logical_to_spec`'s spec."""
    return spec_to_placements(logical_to_spec(logical, shape, mesh, rules), mesh)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _shape_of(leaf) -> tuple:
    """A meta (or any) tensor's shape, or a ``(shape, dtype)`` pair's."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def tree_shardings(shape_tree, logical_tree, mesh, rules: ShardingRules):
    """Map a tree of abstract tensors (nested dicts of meta tensors or
    ``(shape, dtype)`` pairs; a flat ``{parameter name: ...}`` dict is one)
    and a parallel tree of logical axes to placements."""
    if _is_logical(logical_tree):
        return logical_to_sharding(logical_tree, _shape_of(shape_tree), mesh, rules)
    return {key: tree_shardings(shape_tree[key], sub, mesh, rules)
            for key, sub in logical_tree.items()}


def mesh_device(mesh) -> torch.device:
    """This rank's device of a ``DeviceMesh``: its current card, or the CPU.
    In a world of fake ranks (``launch/dryrun.py``: one process stands for
    every rank and no card need exist) the card is the rank's place among
    the host's cards, ``rank % device_count`` (``cuda:0`` without one), as
    ``launch/mesh.py::slice_mesh`` places ranks."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    if dist.get_backend() == "fake":
        return torch.device("cuda", mesh.get_rank() % max(torch.cuda.device_count(), 1))
    return torch.device("cuda", torch.cuda.current_device())


def local_shard(full: torch.Tensor, mesh, placements: tuple) -> torch.Tensor:
    """This rank's shard of ``full`` (which every rank holds alike) under
    ``placements``: each ``Shard(d)`` splits dim ``d`` evenly, in mesh-dim
    order, the first mesh dim the major one (DTensor's order).  A view."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            step = out.shape[p.dim] // n
            out = out.narrow(p.dim, coord[i] * step, step)
    return out


def distribute(full: torch.Tensor, mesh, placements: tuple) -> DTensor:
    """A DTensor of ``full`` (which every rank holds alike): each rank keeps
    a copy of its shard, on the mesh's device; no collective runs."""
    local = local_shard(full, mesh, placements).to(mesh_device(mesh), copy=True)
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements), run_check=False,
                              shape=full.shape, stride=_contiguous_stride(full.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def sharded_zeros(shape, dtype, mesh, placements: tuple) -> DTensor:
    """A DTensor of zeros whose every rank allocates only its shard."""
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=mesh_device(mesh)), mesh,
                              tuple(placements), run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute_params(model, shardings: dict, mesh):
    """Replace each parameter of ``model`` (``{name: placements}``) by a
    DTensor parameter of its value; returns ``model``."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        value = distribute(p.detach(), mesh, shardings[name])
        setattr(module, leaf, torch.nn.Parameter(value, requires_grad=p.requires_grad))
    return model


def with_logical_constraint(x, logical: Sequence[str | None], mesh, rules: ShardingRules):
    """Activation sharding anchor: a DTensor ``x`` redistributed to the
    rule's placements (no-op without a mesh, or on a plain tensor)."""
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = logical_to_sharding(logical, x.shape, mesh, rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


# -- ambient activation-sharding context ------------------------------------------
#
# Model code is mesh-agnostic; launchers activate a (mesh, rules) context and
# the layers call ``constrain`` to anchor activation shardings (batch over
# ("pod","data"), seq over "model" between layers in training, ...).  The
# stack is per thread: the trial-slice scheduler runs trials in threads.

_LOCAL = threading.local()


def _stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


class activation_sharding:
    def __init__(self, mesh, rules: ShardingRules):
        self.pair = (mesh, rules)

    def __enter__(self):
        _stack().append(self.pair)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def active() -> "tuple | None":
    """The innermost active ``(mesh, rules)`` of this thread, or ``None``."""
    stack = _stack()
    return stack[-1] if stack else None


class side_by_side:
    """Marks a call whose batch holds ``k`` microbatches side by side
    (``train.train_loop._rows``): the batch is ``k`` microbatches'
    consecutive rows, laid over the batch axes as any batch is, so that the
    outer batch axes (the product of their sizes ``k``) tell the
    microbatches apart and each microbatch's rows lie over the inner ones,
    ``axes`` (mesh names, in mesh order).  The blocks take every reduction
    that defines a microbatch's function (the loss's mean, the MoE means,
    groups and capacity counts) over its own axes
    (``models/tensor_parallel.py``)."""

    def __init__(self, k: int, axes: Sequence[str] = ()):
        self.k, self.axes = int(k), tuple(axes)

    def __enter__(self):
        _sides().append(self)
        return self

    def __exit__(self, *exc):
        _sides().pop()
        return False


def _sides() -> list:
    if not hasattr(_LOCAL, "sides"):
        _LOCAL.sides = []
    return _LOCAL.sides


def side_by_side_layout() -> "side_by_side | None":
    """This thread's current :class:`side_by_side` layout (``None`` outside
    one)."""
    sides = _sides()
    return sides[-1] if sides else None


def carry_context(fn: Callable) -> Callable:
    """``fn`` run under this thread's current activation context (the
    active ``(mesh, rules)`` and the microbatches side by side) on whatever
    thread calls it: a remat recomputation runs on the autograd engine's
    thread, whose own context is empty."""
    pair, layout = active(), side_by_side_layout() or side_by_side(1)

    def wrapped(*args, **kwargs):
        with activation_sharding(*pair), layout:
            return fn(*args, **kwargs)

    return wrapped


def constrain(x, logical: Sequence[str | None]):
    """Sharding anchor using the ambient (mesh, rules); identity when absent."""
    pair = active()
    if pair is None:
        return x
    return with_logical_constraint(x, logical, *pair)


def wrap_with_sharding_ctx(fn: Callable, mesh, rules: ShardingRules) -> Callable:
    """Make ``fn`` run inside the activation-sharding context."""

    def wrapped(*args, **kwargs):
        with activation_sharding(mesh, rules):
            return fn(*args, **kwargs)

    return wrapped

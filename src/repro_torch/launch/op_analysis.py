"""Per-rank operator accounting of one step, for the roofline analysis: the
port's counterpart of the reference's ``launch/hlo_analysis.py``.

Eager PyTorch has no HLO to read, so :func:`analyze_step` runs the step once
under a ``TorchDispatchMode`` and tallies every operator as it executes:

* **FLOPs** from ``torch.utils.flop_counter``'s formulas: PyTorch's own for
  the aten products and attention, and the ones ``kernels/*.py`` register
  for the port's kernels (``torch.ops.repro_torch.*``, ``kernels/ops.py``).
  An op without a formula that decomposes is counted through its
  decomposition, as ``FlopCounterMode`` counts it.
* **Bytes accessed**: operand plus result bytes of every op that is not a
  view or metadata op (a result that is one of its operands, an in-place
  op's, counts once).  Eager PyTorch writes every op's result to device
  memory, as XLA does at its fusion boundaries, so this is the step's
  device-memory traffic with nothing fused.  Allocations (``empty``) move
  no bytes.
* **Collectives** by kind (all-reduce, all-gather, reduce-scatter,
  all-to-all, send-recv, broadcast) and by mesh dim, ``max(operand,
  result)`` bytes an op (``hlo_analysis.py``'s rule): the functional
  ``_c10d_functional.*`` ops that DTensor's redistributions issue and the
  in-place ``c10d.*_`` ops of ``dist.all_reduce`` and friends (the
  vocab-parallel cross-entropy, ``train/compression.py``,
  ``train/pipeline_parallel.py``).  A collective's bytes also count as
  bytes accessed, as the reference counts them.
* **Peak memory** from ``torch.distributed._tools.mem_tracker.MemTracker``
  (storages rounded to the caching allocator's 512 bytes), split into the
  reference's parts: ``argument_bytes`` (the step's inputs), ``output_bytes``,
  ``alias_bytes`` (outputs that are inputs' storage: parameters updated in
  place, a donated cache) and ``temp_bytes``, what the peak holds beyond
  them; ``per_device_total = argument + temp + output - alias``, the peak
  on the arguments' device.  ``peak_by_category`` keeps the tracker's own
  split at the peak.
* **FLOPs by module** through ``torch.distributed._tools.ModTracker``, in
  place of ``dot_flops_by_comp``: every module whose ``__call__`` is on the
  stack when a product runs, and ``"Global"``.  The port's ``Transformer``
  is a tree of parameters that the functional ``models.forward`` reads, so
  its steps are attributed to ``"Global"`` alone; ``ops`` splits them by
  operator instead.

The reference's ``trip_counts`` has no counterpart: an eager step runs each
loop body's operators as often as the loop runs, so every count here is
already the executed one.

**Rank-local counts.**  Under DTensor the mode steps aside for the DTensor
op (``NotImplemented``), lets DTensor dispatch its local operators, and
counts those, on this rank's shards.  DTensor's sharding propagation runs
each op once more on tensors of the global shape, inside a fake-tensor mode
of its own; the mode tells those calls apart by the active fake mode (a
``TracingContext`` hands DTensor a mode of its own during the step, also
when the step itself runs on fake tensors) and leaves them out.
``FlopCounterMode`` counts both, and a sharded product then reports its
global FLOPs plus its local ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import defaultdict
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch._guards import TracingContext, active_fake_mode, tracing
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed._tools.mod_tracker import ModTracker
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels.ops import OP_NAMESPACE

__all__ = ["analyze_step", "OpStats", "COLLECTIVE_KINDS", "kernel_ops"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "send-recv",
                    "broadcast")

#: "namespace.op" -> kind, for the functional and the in-place collectives
_COLLECTIVES = {
    **{f"_c10d_functional.{op}": kind for op, kind in (
        ("all_reduce", "all-reduce"), ("all_reduce_", "all-reduce"),
        ("all_reduce_coalesced", "all-reduce"), ("all_reduce_coalesced_", "all-reduce"),
        ("all_gather_into_tensor", "all-gather"), ("all_gather_into_tensor_out", "all-gather"),
        ("all_gather_into_tensor_coalesced", "all-gather"),
        ("reduce_scatter_tensor", "reduce-scatter"),
        ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
        ("all_to_all_single", "all-to-all"), ("broadcast", "broadcast"),
        ("broadcast_", "broadcast"))},
    **{f"c10d.{op}": kind for op, kind in (
        ("allreduce_", "all-reduce"), ("allreduce_coalesced_", "all-reduce"),
        ("allgather_", "all-gather"), ("_allgather_base_", "all-gather"),
        ("allgather_coalesced_", "all-gather"), ("allgather_into_tensor_coalesced_", "all-gather"),
        ("reduce_scatter_", "reduce-scatter"), ("_reduce_scatter_base_", "reduce-scatter"),
        ("reduce_scatter_tensor_coalesced_", "reduce-scatter"), ("alltoall_", "all-to-all"),
        ("alltoall_base_", "all-to-all"), ("send", "send-recv"), ("recv_", "send-recv"),
        ("recv_any_source_", "send-recv"), ("broadcast_", "broadcast"))},
}

_aten = torch.ops.aten
#: ops that read or write no tensor data
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default, _aten.sym_size.default,
    _aten.stride.default, _aten.sym_stride.default, _aten.storage_offset.default,
    _aten.sym_storage_offset.default, _aten.numel.default, _aten.sym_numel.default,
    _aten.dim.default, torch.ops.prim.layout.default, torch.ops.prim.device.default,
    torch.ops._c10d_functional.wait_tensor.default,
}
#: allocations and views the schema does not mark as views: nothing is read
#: or written
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
}
#: the caching allocator's granule, as ``MemTracker`` rounds storages
_GRANULE = 512


@dataclasses.dataclass
class OpStats:
    """One step's per-rank totals (``hlo_analysis.HloStats``' fields where
    they mean the same thing; see the module docstring)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    #: kind -> bytes
    collectives: dict = dataclasses.field(default_factory=dict)
    #: mesh dim name -> {kind: bytes}
    collectives_by_dim: dict = dataclasses.field(default_factory=dict)
    n_collective_ops: float = 0.0
    #: module name (``ModTracker``'s) -> FLOPs
    flops_by_module: dict = dataclasses.field(default_factory=dict)
    #: op ("aten.mm", "repro_torch.flash_attention") -> {"count", "flops", "bytes"}
    ops: dict = dataclasses.field(default_factory=dict)
    #: argument / output / alias / temp bytes, per_device_total, peak_by_category
    memory: dict = dataclasses.field(default_factory=dict)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def kernel_ops(stats: "OpStats | dict") -> dict:
    """The port's kernel ops among ``stats``' ops (``OpStats`` or its
    ``asdict()``), by op name without the namespace."""
    ops = stats.ops if isinstance(stats, OpStats) else stats["ops"]
    prefix = f"{OP_NAMESPACE}."
    return {name[len(prefix):]: op for name, op in ops.items() if name.startswith(prefix)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_name(args, kwargs) -> "str | None":
    """The process group a collective runs over: a functional op's
    ``group_name``, its last string argument (a reduce op's name comes
    before it), or an in-place op's process group."""
    name = None
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).group_name
        if isinstance(a, str):
            name = a
    return name


def _mesh_dims(mesh) -> dict:
    """``{group name: mesh dim name}`` of ``mesh``'s dims (and ``"world"``
    for the default group)."""
    names = {}
    if dist.is_initialized():
        names[dist.group.WORLD.group_name] = "world"
    if mesh is not None:
        for i, dim in enumerate(mesh.mesh_dim_names or range(mesh.ndim)):
            names[mesh.get_group(i).group_name] = str(dim)
    return names


def _find_mesh(tree):
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            for p in x.parameters():
                if isinstance(p, DTensor):
                    return p.device_mesh
        elif isinstance(x, DTensor):
            return x.device_mesh
    return None


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats, dims: dict, mods: ModTracker, fake):
        super().__init__()
        self.stats, self.dims, self.mods, self.fake = stats, dims, mods, fake
        self.by_kind = defaultdict(float)
        self.by_dim = defaultdict(lambda: defaultdict(float))
        self.by_module = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches its local ops, which land here
        if func in _METADATA or active_fake_mode() is not self.fake:
            return func(*args, **kwargs)  # metadata, or DTensor's sharding propagation
        packet = func._overloadpacket
        if packet not in flop_counter.flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        name = f"{func.namespace}.{packet.__name__}"
        op = self.stats.ops.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        op["count"] += 1
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            op["flops"] += f
            self.stats.flops += f
            for mod in set(self.mods.parents):
                self.by_module[mod] += f
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            if func.namespace == "c10d":  # in place: args[0] is written, args[1] read
                first = sum(_nbytes(t) for t in _tensors(args[0]))
                second = sum(_nbytes(t) for t in _tensors(args[1]))
                moved, touched = max(first, second), first + second
            else:
                operand = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                result = sum(_nbytes(t) for t in _tensors(out))
                moved, touched = max(operand, result), operand + result
            group = _group_name(args, kwargs)
            dim = self.dims.get(group, group or "unknown")
            self.by_kind[kind] += moved
            self.by_dim[dim][kind] += moved
            self.stats.collective_bytes += moved
            self.stats.n_collective_ops += 1
            op["bytes"] += touched
            self.stats.bytes_accessed += touched
            return
        if func.is_view or func in _NO_BYTES:
            return
        operands = _tensors((args, kwargs))
        seen = {id(t) for t in operands}
        b = (sum(_nbytes(t) for t in operands)
             + sum(_nbytes(t) for t in _tensors(out) if id(t) not in seen))
        op["bytes"] += b
        self.stats.bytes_accessed += b


def _storage_bytes(tensors) -> "tuple[int, set]":
    """Bytes of the distinct storages under ``tensors`` (a DTensor's local
    shard), each rounded up to the allocator's granule, and their ids."""
    seen: set = set()
    total = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        key = st._cdata
        if key not in seen:
            seen.add(key)
            total += math.ceil(st.nbytes() / _GRANULE) * _GRANULE
    return total, seen


def _args_tensors(tree) -> list:
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def analyze_step(fn: Callable, *args, mesh=None, memory: bool = True, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once and return this rank's
    :class:`OpStats`.  ``mesh`` names the collectives' mesh dims (default:
    the mesh of the first DTensor among the arguments).  On fake tensors
    (under a ``FakeTensorMode``, in a fake world) nothing runs on a device
    and the counts are the ones a real run of the same step gives."""
    mesh = mesh if mesh is not None else _find_mesh((args, kwargs))
    stats = OpStats()
    fake = active_fake_mode()
    inputs = _args_tensors((args, kwargs))
    tracker = MemTracker() if memory else None
    if tracker is not None:
        tracker.track_external(*[x for x in tree_flatten((args, kwargs))[0]
                                 if isinstance(x, (torch.nn.Module, torch.Tensor))])
    mods = ModTracker()
    counter = _Counter(stats, _mesh_dims(mesh), mods, fake)
    with contextlib.ExitStack() as stack:
        # DTensor's sharding propagation takes the TracingContext's fake mode
        stack.enter_context(tracing(TracingContext(FakeTensorMode())))
        if tracker is not None:
            stack.enter_context(tracker)
        stack.enter_context(mods)
        stack.enter_context(counter)
        out = fn(*args, **kwargs)
    stats.collectives = {k: counter.by_kind[k] for k in COLLECTIVE_KINDS if k in counter.by_kind}
    stats.collectives_by_dim = {d: dict(v) for d, v in counter.by_dim.items()}
    stats.flops_by_module = dict(counter.by_module)
    if tracker is not None:
        stats.memory = _memory(tracker, inputs, out)
    return stats


def _memory(tracker: MemTracker, inputs: list, out: Any) -> dict:
    """The peak on the arguments' device.  Another device's entries are
    not the step's: DTensor's sharding propagation makes its fake tensors
    of the global shape on the CPU (a 45 GiB KV cache at smollm-135m's
    decode_32k), and the tracker of some PyTorch versions counts them."""
    peak = tracker.get_tracker_snapshot("peak")
    if not peak:
        return {}
    if inputs:
        first = inputs[0]
        dev = (first.to_local() if isinstance(first, DTensor) else first).device
    else:
        dev = max(peak, key=lambda d: peak[d]["Total"])
    snap = peak[dev]
    argument, arg_storages = _storage_bytes(inputs)
    outputs = _tensors(out)
    output, _ = _storage_bytes(outputs)
    alias, _ = _storage_bytes([t for t in outputs
                               if (t.to_local() if isinstance(t, DTensor) else t)
                               .untyped_storage()._cdata in arg_storages])
    total = snap["Total"]
    return {
        "device": str(dev),
        "argument_bytes": argument,
        "output_bytes": output,
        "alias_bytes": alias,
        "temp_bytes": max(0, total - argument - output + alias),
        "per_device_total": max(total, argument + output - alias),
        "peak_by_category": {str(k.value if hasattr(k, "value") else k): v
                             for k, v in snap.items()},
    }

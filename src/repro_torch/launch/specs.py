"""Abstract input/step construction for the sharded launchers:
``input_specs`` (meta-device stand-ins for every model input) and
``build_step`` (the step with its inputs' DTensor placements for a given
cell), and the memory rule by which a prefill cell runs each rank's rows
in chunks (:func:`prefill_peak_bytes`, :func:`prefill_row_chunks`).

A :class:`Cell`'s ``args`` are abstract: a ``Transformer`` on the meta
device, the optimizer state and the batch as meta tensors (no storage).
``in_shardings`` holds their placements.  :meth:`Cell.shard` distributes
real inputs of any size the same way, the placements recomputed from the
real shapes by the same logical axes and rules, and the step runs on them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import _disable_current_modes

from ..models import (
    SHAPES,
    ModelConfig,
    Transformer,
    abstract_params,
    cache_logical,
    init_cache,
    named_params_logical,
    param_specs,
    params_logical,
)
from ..models.layers import spec_shapes
from ..models.moe import EXPERT_ROWS, _capacity, group_size
from ..models.sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    ShardingRules,
    axis_sizes,
    dim_names,
    distribute,
    distribute_params,
    logical_to_sharding,
    logical_to_spec,
    tree_shardings,
    wrap_with_sharding_ctx,
)
from ..models.sharding import _contiguous_stride
from ..serve import make_decode_step, make_prefill_step
from ..train.optimizer import Optimizer
from ..train.train_loop import TrainConfig, _opt_shardings, make_optimizer_for, make_train_step
from .roofline import HBM_BYTES

__all__ = ["input_specs", "build_step", "Cell", "prefill_peak_bytes", "prefill_row_chunks"]

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_abstract(cfg: ModelConfig, batch: int, seq: int) -> dict:
    i32 = torch.int32
    if cfg.modality == "audio":
        return {
            "tokens": _meta((batch, cfg.num_codebooks, seq), i32),
            "labels": _meta((batch, cfg.num_codebooks, seq), i32),
        }
    if cfg.modality == "vlm":
        return {
            "tokens": _meta((batch, seq - cfg.img_tokens), i32),
            "image_embeds": _meta((batch, cfg.img_tokens, cfg.d_model), torch.bfloat16),
            "labels": _meta((batch, seq), i32),
        }
    return {"tokens": _meta((batch, seq), i32), "labels": _meta((batch, seq), i32)}


def _batch_logical(name: str, ndim: int) -> tuple:
    if name == "image_embeds":
        return ("batch", None, None)
    if ndim == 3:  # audio [B, K, S]
        return ("batch", None, "seq")
    return ("batch", "seq")


def _batch_shardings(batch_abs: dict, mesh, rules: ShardingRules) -> dict:
    return {k: logical_to_sharding(_batch_logical(k, v.dim()), v.shape, mesh, rules)
            for k, v in batch_abs.items()}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every input of the cell's step function
    (no device allocation)."""
    shp = SHAPES[shape_name]
    if shp.kind in ("train", "prefill"):
        return _batch_abstract(cfg, shp.global_batch, shp.seq_len)
    # decode: one new token against a seq_len cache
    if cfg.modality == "audio":
        return {"tokens": _meta((shp.global_batch, cfg.num_codebooks, 1), torch.int32)}
    return {"tokens": _meta((shp.global_batch, 1), torch.int32)}


def _abstract_model(cfg: ModelConfig, dtype: torch.dtype) -> Transformer:
    return Transformer(cfg, device="meta").to(dtype)


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) unit: a step fn + fully-specified abstract
    args + their placements.  ``kind`` is the shape's (train / prefill /
    decode); ``mesh`` and ``rules`` are the cell's, for :meth:`shard`.
    ``plans`` is a prefill step's decision for each batch shape it has run,
    ``{(rows, positions): (row chunks a rank, the memory rule's estimate at
    them)}``."""

    name: str
    step: Callable
    args: tuple
    in_shardings: tuple
    donate: tuple = ()
    kind: str = "train"
    mesh: Any = None
    rules: ShardingRules | None = None
    plans: dict = dataclasses.field(default_factory=dict)

    def shard(self, *args) -> tuple:
        """Real inputs in the positions of ``args`` distributed by the same
        logical axes and rules: a ``Transformer`` (its parameters cast to
        the abstract model's dtype, then replaced by DTensors), the
        optimizer state, the batch, a cache; ints and ``None`` pass through.  Every rank
        must pass the same values (:func:`~repro_torch.models.sharding.distribute`
        keeps each rank's shard; no collective runs)."""
        out = []
        for pos, (value, abstract) in enumerate(zip(args, self.args)):
            if value is None or isinstance(value, int):
                out.append(value)
            elif isinstance(value, Transformer):
                _cast_params(value, next(abstract.parameters()).dtype)
                names = dict(value.named_parameters())
                logical = named_params_logical(value.cfg)
                sh = {n: logical_to_sharding(logical[n], p.shape, self.mesh, self.rules)
                      for n, p in names.items()}
                out.append(distribute_params(value, sh, self.mesh))
            elif self.kind == "train" and pos == 1:  # the optimizer state
                out.append(self._shard_opt(value))
            elif isinstance(value, dict) and any(k in value for k in ("head", "stack", "tail")):
                logical = cache_logical(value)
                out.append(_map(lambda t, lg: distribute(t, self.mesh, logical_to_sharding(
                    lg, t.shape, self.mesh, self.rules)), value, logical))
            elif isinstance(value, dict):
                out.append({k: distribute(v, self.mesh, logical_to_sharding(
                    _batch_logical(k, v.dim()), v.shape, self.mesh, self.rules))
                    for k, v in value.items()})
            elif isinstance(value, torch.Tensor) and value.dim() in (2, 3):  # decode tokens
                # [B, 1], or audio [B, K, 1]: laid out as build_step lays them
                out.append(distribute(value, self.mesh, logical_to_sharding(
                    ("batch", None, None)[:value.dim()], value.shape, self.mesh, self.rules)))
            else:
                out.append(value)
        return tuple(out)

    def _shard_opt(self, state: dict) -> dict:
        cfg = self.args[0].cfg
        p_tree = tree_shardings(abstract_params(cfg), params_logical(cfg), self.mesh, self.rules)
        o_sh = _opt_shardings(state, p_tree, self.mesh)
        return _map(lambda t, pl: distribute(t, self.mesh, pl), state, o_sh)


def _cast_params(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Each parameter of another dtype replaced by a parameter of its value
    cast to ``dtype`` (``Module.to`` would swap tensors, which fake tensors
    refuse); the model has no buffers."""
    for name, p in list(model.named_parameters()):
        if p.dtype != dtype:
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            setattr(module, leaf, torch.nn.Parameter(p.detach().to(dtype),
                                                     requires_grad=p.requires_grad))


def _map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _serve_rules(cfg: ModelConfig) -> ShardingRules:
    if cfg.serve_fsdp:
        return ShardingRules({**SERVE_RULES.rules, "fsdp_embed": ("pod", "data")})
    return SERVE_RULES


def _local_bytes(tree, placements, mesh) -> int:
    """Bytes a rank holds of a tree of meta tensors laid out as
    ``placements`` (a parallel tree)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v, placements[k], mesh) for k, v in tree.items())
    sizes = axis_sizes(mesh)
    split = math.prod(sizes[n] for n, p in zip(dim_names(mesh), placements) if isinstance(p, Shard))
    return tree.numel() * tree.element_size() // split


def _rank_rows(batch: int, mesh, rules: ShardingRules) -> int:
    """A rank's rows of a batch of ``batch`` (the batch axes that divide it)."""
    spec = logical_to_spec(("batch",), (batch,), mesh, rules)
    axes = () if not spec else (spec[0],) if isinstance(spec[0], str) else spec[0]
    sizes = axis_sizes(mesh)
    return batch // math.prod(sizes[a] for a in axes)


def _rows_positions(shape) -> tuple:
    """``(rows, positions)`` of a shape name or of such a pair."""
    if isinstance(shape, str):
        return SHAPES[shape].global_batch, SHAPES[shape].seq_len
    return tuple(shape)


#: the FFN kinds whose activations the rule's "dense" term counts
_DENSE_FFNS = ("swiglu", "geglu", "gelu")


def _sub_block_bytes(cfg: ModelConfig, kind: str, rows: int, seq: int, batch: int, tp: int,
                     cb: int) -> int:
    """The bytes a prefill's sub-block of ``kind`` holds at its peak on a
    rank running ``rows`` rows of ``seq`` positions (of a batch of ``batch``
    rows), ``tp`` the model axis's size and ``cb`` the compute dtype's
    bytes: the terms :func:`prefill_peak_bytes` lists."""
    n, d = rows * seq, cfg.d_model

    def local(width, over):  # a width over the model axis where ``over`` divides it
        return width // tp if over % tp == 0 else width

    if kind == "dense":
        ff = max([local(b.d_ff or cfg.d_ff, b.d_ff or cfg.d_ff) for b, _ in cfg.all_blocks()
                  if b.ffn in _DENSE_FFNS] + [0])
        return n * (5 * cb * d + 12 * d + 3 * cb * ff)
    if kind == "attn":  # the local heads, or every head where the kv heads do not divide
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if H % tp == 0 and KV % tp == 0:
            H, KV = H // tp, KV // tp
        return n * (2 * cb * d + cb * (H + 2 * KV) * D + 8 * H * D + 6 * D + 8)
    if kind == "mla":  # every head on every rank
        H, L, R, qc = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim, min(cfg.prefill_q_chunk, seq)
        width = 2 * d + H * (cfg.qk_nope_dim + 2 * R + L + cfg.v_head_dim) + L + R
        return n * (cb * width + 4 * (L + R)) + rows * 3 * 4 * H * qc * seq
    if kind == "moe":
        E, k = cfg.moe_experts, cfg.moe_top_k
        shared = local(cfg.moe_shared_d_ff, cfg.moe_shared_d_ff or 1)
        tokens = n * (5 * cb * d + 4 * d + 36 * E + 32 * k + 3 * cb * shared)
        if cfg.moe_dispatch == "sort":
            rows_e = min(_capacity(batch * seq, cfg), n)
            return (tokens + n * k * (4 * cb * d + 96)
                    + local(E, E) * rows_e * cb * (2 * d + 3 * cfg.moe_d_ff))
        sg = group_size(batch * seq, cfg)
        c = _capacity(sg, cfg)
        groups = min(-(-n // sg), max(1, EXPERT_ROWS // (E * c)))
        return tokens + groups * sg * E * c * (cb + 8)
    if kind == "mlstm":
        H, di = cfg.n_heads, cfg.ssm_proj_factor * d
        if H % tp == 0:
            H, di = H // tp, di // tp
        held = n * cb * (2 * d + 5 * di)
        chunk = rows * (16 + cb) * H * min(cfg.q_chunk, seq) * seq
        return held + max(n * 4 * di + chunk, n * 16 * di)
    if kind == "slstm":
        dl = local(d, cfg.n_heads)
        return n * (2 * cb * d + 8 * cb * dl + 20 * dl)
    if kind == "mamba2":
        di, G, N = cfg.ssm_expand * d, cfg.ssm_groups, cfg.ssm_state
        H = di // cfg.ssm_head_dim
        if H % tp == 0:
            di, H = di // tp, H // tp
        return n * (2 * cb * d + cb * (4 * di + 4 * G * N + H) + 4 * H + 28 * di)
    raise ValueError(f"the memory rule does not count a {kind} block")


def _gathered_bytes(cfg: ModelConfig, params, mesh) -> int:
    """A ``serve_fsdp`` superblock's weights as its call gathers them over
    the batch axes: the layer stack's shards under ``SERVE_RULES`` over its
    depth."""
    if not cfg.serve_fsdp:
        return 0
    stack, logical = params["stack"], params_logical(cfg)["stack"]
    return _local_bytes(stack, tree_shardings(stack, logical, mesh, SERVE_RULES),
                        mesh) // cfg.n_superblocks


def prefill_peak_bytes(cfg: ModelConfig, shape, mesh, rules: ShardingRules,
                       chunks: int = 1) -> int:
    """A rank's estimated peak bytes in a prefill of ``shape`` (a shape
    name, or a ``(rows, positions)`` pair) with each rank's rows run in
    ``chunks`` chunks, from shapes alone (``mesh`` a ``DeviceMesh`` or a
    ``{name: size}`` map; meta tensors only): the resident bytes plus the
    largest of its sub-blocks' peaks (:func:`_sub_block_bytes`).  It counts:

    * resident: the serving weights' shards (``cfg.serve_param_dtype``) and
      the shards of a bf16 cache of the prompt's length, by
      ``tree_shardings``; with ``serve_fsdp`` one superblock's weights
      gathered over the batch axes;
    * every block, at each position of a chunk's rows: the residual twice
      (a block's input and output) in the compute dtype, the block's partial
      output and its all-reduced copy, the float32 norm temporaries
      (``x32``, ``y``, ``y * (1 + scale)``) and the norm's output, and three
      activations of a dense FFN's local width;
    * attention: the input and its norm, q / k / v on the heads the rank
      runs, q's float32 rope temporaries, the rope tables;
    * MLA (every head on a rank): the input and its norm, q, its roped part,
      ``q @ w_uk``, the latent and rope keys and their float32 copies, the
      chunks' outputs, and a row's three float32 score chunks;
    * MoE: the residuals, the norm and its float32 copy, the router's
      probabilities and routing indices, the shared experts' activations;
      the einsum dispatch's one block of dispatch and float32 combine
      tensors (the scatter's zeros beside its result), the sort dispatch's
      gathered pairs and expert buffers;
    * mLSTM: the input, its norm, the up-projection, q, k, the output, and
      the larger of the parallel form's float32 keys and a row's score
      chunks (four float32, one in the compute dtype) or the fold's four
      float32 copies of k / v;
    * sLSTM: the input, its norm, the gate pre-activations twice, the
      float32 hidden sequence and its norm's temporaries;
    * mamba2: the input, its norm, the in-projection and conv outputs on the
      local heads, and the float32 SSD output, its skip sum and norm.

    A block kind it does not count raises ``ValueError``.  It leaves out
    the inputs and the last-token logits."""
    batch, seq = _rows_positions(shape)
    dtype = getattr(torch, cfg.serve_param_dtype)
    params = spec_shapes(param_specs(cfg), dtype)
    weights = _local_bytes(params, tree_shardings(params, params_logical(cfg), mesh, rules), mesh)
    cache = init_cache(cfg, batch, seq, torch.bfloat16, device="meta")
    cached = _local_bytes(cache, tree_shardings(cache, cache_logical(cache), mesh, rules), mesh)
    sizes = axis_sizes(mesh)
    tp = next((sizes[a] for a in rules.mesh_axes("heads") if a in sizes), 1)
    cb = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    blocks = [b for b, _ in cfg.all_blocks()]
    kinds = {"dense", *(b.kind for b in blocks),
             *(b.ffn for b in blocks if b.ffn not in ("none", *_DENSE_FFNS))}
    rows = _rank_rows(batch, mesh, rules) // chunks
    peak = max(_sub_block_bytes(cfg, k, rows, seq, batch // chunks, tp, cb) for k in kinds)
    return weights + cached + _gathered_bytes(cfg, params, mesh) + peak


def _rows_independent(cfg: ModelConfig, batch: int, seq: int) -> bool:
    """Whether a prefill's rows are functions of their own tokens alone: no
    MoE FFN, or the einsum dispatch whose groups (``moe.group_size`` of the
    batch's tokens) lie within a row; the sort dispatch's capacity is over
    all the batch's tokens."""
    if not any(b.ffn == "moe" for b, _ in cfg.all_blocks()):
        return True
    return cfg.moe_dispatch == "einsum" and seq % group_size(batch * seq, cfg) == 0


def prefill_row_chunks(cfg: ModelConfig, shape, mesh, rules: ShardingRules,
                       budget: float = HBM_BYTES) -> int:
    """The fewest chunks ``R`` (a divisor of a rank's rows) of a prefill of
    ``shape`` whose :func:`prefill_peak_bytes` fits ``budget`` (by default a
    card's, ``roofline.HBM_BYTES``).  Raises ``ValueError`` where ``R > 1``
    is needed and the rows are not independent (:func:`_rows_independent`),
    or where one row a chunk does not fit either."""
    batch, seq = _rows_positions(shape)
    rows = _rank_rows(batch, mesh, rules)
    chunks = next((r for r in range(1, rows + 1)
                   if rows % r == 0 and prefill_peak_bytes(cfg, shape, mesh, rules, r) <= budget),
                  None)
    if chunks == 1:
        return 1
    what = (f"a prefill of {batch} x {seq} of {cfg.name} needs "
            f"{prefill_peak_bytes(cfg, shape, mesh, rules)} bytes a rank, over {budget:.0f}")
    if not _rows_independent(cfg, batch, seq):
        raise ValueError(f"{what}, and its rows cannot run in chunks: its MoE dispatch "
                         f"({cfg.moe_dispatch}, groups of {group_size(batch * seq, cfg)} tokens) "
                         f"spans rows")
    if chunks is None:
        raise ValueError(f"{what}, even one row a chunk")
    return chunks


def _row_chunk(t: DTensor, dim: int, i: int, chunks: int) -> DTensor:
    """Chunk ``i`` of ``chunks`` of every rank's local rows (tensor dim
    ``dim``) of ``t``: a DTensor with ``t``'s placements over a view of its
    local shard, so that writes into it land in ``t``."""
    local = t.to_local()
    if local.shape[dim] % chunks:
        raise ValueError(f"{local.shape[dim]} rows a rank do not split into {chunks} chunks")
    r = local.shape[dim] // chunks
    shape = list(t.shape)
    shape[dim] //= chunks
    return DTensor.from_local(local.narrow(dim, i * r, r), t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _chunked_prefill(prefill: Callable, plan: Callable, cache_rows: dict, plans: dict) -> Callable:
    """``prefill`` with each rank's rows of the batch it is given in the
    chunks ``plan((rows, positions))`` returns first (with the rule's
    estimate), kept in ``plans`` once a batch shape (computed outside any
    dispatch mode around the step): one call of
    ``prefill`` a chunk, the batch's and the cache's rows (the cache's row
    dims ``cache_rows``, a tree parallel to it) as :func:`_row_chunk` views,
    the cache updated in place, the last-token logits concatenated in row
    order.  The weights are the same DTensors in every chunk; one chunk is
    ``prefill`` itself."""
    def step(model, batch, cache):
        tokens = batch["tokens"]
        key = (tokens.shape[0], tokens.shape[-1] + (batch["image_embeds"].shape[1]
                                                    if "image_embeds" in batch else 0))
        if key not in plans:  # meta tensors only, which a counting or fake mode must not see
            with _disable_current_modes():
                plans[key] = plan(key)
        chunks = plans[key][0]
        if chunks == 1:
            return prefill(model, batch, cache)
        parts = []
        for i in range(chunks):
            rows = {k: _row_chunk(v, 0, i, chunks) for k, v in batch.items()}
            logits, _ = prefill(model, rows, _map(lambda t, d: _row_chunk(t, d, i, chunks),
                                                  cache, cache_rows))
            parts.append(logits)
        first = parts[0]
        local = torch.cat([p.to_local() for p in parts])
        return DTensor.from_local(local, first.device_mesh, first.placements, run_check=False,
                                  shape=torch.Size((first.shape[0] * chunks, *first.shape[1:])),
                                  stride=first.stride()), cache

    return step


def build_step(cfg: ModelConfig, shape_name: str, mesh, tcfg: TrainConfig | None = None,
               opt: Optimizer | None = None, memory_budget: float = HBM_BYTES) -> Cell:
    """The cell's step under ``TRAIN_RULES`` (train) or ``SERVE_RULES``
    (prefill, decode; with ``cfg.serve_fsdp`` the weights' d_model dim over
    the batch axes too).  A train cell's optimizer is ``opt``, by default
    ``make_optimizer_for(cfg, tcfg)``.  A prefill cell's step runs each
    rank's rows of the batch it is given in :func:`prefill_row_chunks`
    chunks against ``memory_budget`` bytes a rank (one chunk, the whole
    batch, wherever it fits; ``ValueError`` where the rows cannot be
    chunked).  ``mesh`` may be a ``{name: size}`` map to read a cell's
    placements without processes; its step then cannot run."""
    shp = SHAPES[shape_name]
    p_logical = named_params_logical(cfg)

    if shp.kind == "train":
        rules = TRAIN_RULES
        model = _abstract_model(cfg, getattr(torch, cfg.param_dtype))
        aps = dict(model.named_parameters())
        p_sh = tree_shardings(aps, p_logical, mesh, rules)
        opt = opt or make_optimizer_for(cfg, tcfg or TrainConfig())
        opt_abs = opt.init(aps)
        p_tree = tree_shardings(abstract_params(cfg), params_logical(cfg), mesh, rules)
        o_sh = _opt_shardings(opt_abs, p_tree, mesh)
        batch_abs = input_specs(cfg, shape_name)
        b_sh = _batch_shardings(batch_abs, mesh, rules)
        step = wrap_with_sharding_ctx(make_train_step(cfg, opt, cfg.train_microbatch), mesh, rules)
        return Cell(
            name=f"{cfg.name}:{shape_name}",
            step=step,
            args=(model, opt_abs, 0, batch_abs),
            in_shardings=(p_sh, o_sh, None, b_sh),
            donate=(0, 1),
            kind="train", mesh=mesh, rules=rules,
        )

    rules = _serve_rules(cfg)
    # serving runs on bf16 weights (f32 masters stay in the checkpoint)
    model = _abstract_model(cfg, getattr(torch, cfg.serve_param_dtype))
    p_sh = tree_shardings(dict(model.named_parameters()), p_logical, mesh, rules)
    cache_abs = init_cache(cfg, shp.global_batch, shp.seq_len, torch.bfloat16, device="meta")
    c_sh = tree_shardings(cache_abs, cache_logical(cache_abs), mesh, rules)

    if shp.kind == "prefill":
        batch_abs = input_specs(cfg, shape_name)
        b_sh = _batch_shardings(batch_abs, mesh, rules)
        rows = _map(lambda t, lg: lg.index("batch"), cache_abs, cache_logical(cache_abs))

        def plan(shape):
            chunks = prefill_row_chunks(cfg, shape, mesh, rules, memory_budget)
            return chunks, prefill_peak_bytes(cfg, shape, mesh, rules, chunks)

        plans: dict = {}
        step = _chunked_prefill(make_prefill_step(cfg), plan, rows, plans)
        return Cell(
            name=f"{cfg.name}:{shape_name}",
            step=wrap_with_sharding_ctx(step, mesh, rules),
            args=(model, batch_abs, cache_abs),
            in_shardings=(p_sh, b_sh, c_sh),
            donate=(2,),
            kind="prefill", mesh=mesh, rules=rules, plans=plans,
        )

    # decode
    tok_abs = input_specs(cfg, shape_name)["tokens"]
    tok_logical = ("batch", None, None)[: tok_abs.dim()]
    t_sh = logical_to_sharding(tok_logical, tok_abs.shape, mesh, rules)
    step = wrap_with_sharding_ctx(make_decode_step(cfg), mesh, rules)
    return Cell(
        name=f"{cfg.name}:{shape_name}",
        step=step,
        args=(model, tok_abs, cache_abs, 0),
        in_shardings=(p_sh, t_sh, c_sh, None),
        donate=(2,),
        kind="decode", mesh=mesh, rules=rules,
    )

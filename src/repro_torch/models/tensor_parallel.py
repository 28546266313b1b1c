"""The model's blocks on local shards, under an active mesh.

``models/sharding.py`` stores every parameter as a DTensor in the rules'
placements (FSDP over the batch axes, tensor parallelism over ``"model"``).
Each block here is one call on local shards, Megatron style: its inputs are
redistributed to the layout its local computation needs (the activation
whole along the sequence and replicated over ``"model"``, the batch still
split; the weights gathered over the batch axes, split over ``"model"``
along heads, FFN width or experts), the one-device code runs on the local
tensors (the flash-attention, SSD and cross-entropy kernels on the local
heads or vocabulary shard), and the output is a DTensor that is a partial
sum over ``"model"``.  DTensor inserts the collectives: the all-gathers of
the redistributions, the reduce-scatter or all-reduce when the partial
output joins the residual stream, and in the backward pass their adjoints.

The rule for gradients: a mesh dim *splits* a block's work when the batch
is sharded over it or the block divides its heads / width / experts over it.
An input that is replicated over a splitting dim gets a partial-sum gradient
there (each rank saw a part of the tokens or of the heads); an output that is
not sharded over a splitting dim is a partial sum there.  Where a block
cannot split over ``"model"`` (the head count does not divide it) every
rank computes the whole block and the output is replicated.

What each block adds to the reference's anchors: the activation constraint
between layers is the caller's (``transformer.forward``); the attention
block's Megatron layout (q / k / v over heads) and the MoE block's experts
over ``"model"`` are this module's local layouts.

The serving caches stay in the layouts ``SERVE_RULES`` give them and are
written in place on each rank's shard:

* a KV cache split along ``head_dim`` (kv heads that do not divide
  ``"model"``) runs the attention block whole on every rank and contracts
  ``head_dim`` across the model axis (:func:`_attn_head_dim`);
* a KV or MLA cache split along its sequence (``kv_seq`` over the batch
  axes the batch leaves free) keeps the reference's layout, the whole
  sequence on each rank: prefill writes the rows a shard owns, decode
  combines the shards' softmax with three small all-reduces a layer
  (:func:`_attend_cache`, :func:`_decode_probs`);
* the MLA cache's latent and rope columns over ``"model"``: decode contracts
  them with one all-reduce of the partial scores (:func:`_mla_cache`);
* the mamba2 SSD state over heads, as the local heads; the conv cache's
  column shards gathered over ``"model"`` (:func:`_mamba2`);
* MoE dispatch groups that the batch shards cut (a decode step's few tokens
  a rank) take the covering groups' choices from every batch shard
  (:func:`_cut_groups`); the sort dispatch counts the earlier shards' pairs
  of each expert (:func:`_moe`);
* the xLSTM caches: over heads, as the local heads (mLSTM ``C`` / ``n`` /
  ``m``, sLSTM ``c`` / ``n`` / ``h`` / ``m``); where the heads do not divide
  the model axis, along ``head_dim``: the mLSTM ``C``'s key rows and ``n``,
  whose decode contraction sums over the model axis (:func:`_mlstm`), and
  the sLSTM state, gathered over the model axis for the recurrence, which
  reads whole heads at every step (:func:`_slstm`).

The logits are a local product of the batch rows and the vocabulary shard
(:func:`logits_from_hidden`).  A cache layout a block cannot serve raises
``NotImplementedError`` naming the leaf's placements.

A train step's microbatches may run side by side (``sharding.side_by_side``,
``train.train_loop._rows``): the loss's mean and the MoE block's means,
groups and capacity counts are then each microbatch's, over its own batch
axes (:func:`_microbatch_axes`).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels.crossentropy import crossentropy_backward, crossentropy_forward
from ..kernels.ops import full_float32_matmul
from ..kernels.ref import crossentropy_lse_ref
from . import attention as attn
from . import mamba2 as m2
from . import ssm_xlstm as xl
from .layers import check_engine, rms_norm, softcap
from .moe import _moe_einsum, _moe_sort, group_size, route
from .sharding import active, local_shard, logical_to_spec, side_by_side_layout

__all__ = [
    "apply_block",
    "embed_tokens",
    "rms_norm_rows",
    "cross_entropy",
    "logits_from_hidden",
]


# -- local calls ----------------------------------------------------------------------------


class _Local:
    """One block's call on local shards: the mesh, its names, and the mesh
    dims over which the block's work is split."""

    def __init__(self, mesh, split: set):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.split = {self.names.index(a) for a in split}

    def placements(self, dims: dict) -> tuple:
        """``dims``: ``{tensor dim: mesh axis or tuple of axes}``."""
        pl: list = [Replicate()] * len(self.names)
        for d, axes in dims.items():
            for ax in (axes,) if isinstance(axes, str) else axes:
                pl[self.names.index(ax)] = Shard(d)
        return tuple(pl)

    def arg(self, t: DTensor, dims: dict | None = None) -> torch.Tensor:
        """The local tensor of ``t`` in the layout ``dims``; its gradient is
        a partial sum over the splitting dims it is replicated over."""
        if not isinstance(t, DTensor):
            raise TypeError(f"under an active mesh the model's tensors are DTensors, got "
                            f"{type(t).__name__}")
        pl = self.placements(dims or {})
        grad = tuple(Partial() if isinstance(p, Replicate) and i in self.split else p
                     for i, p in enumerate(pl))
        if tuple(t.placements) != pl:
            t = t.redistribute(self.mesh, pl)
        return t.to_local(grad_placements=grad)

    def out(self, local: torch.Tensor, dims: dict | None = None, reduced=()) -> DTensor:
        """A DTensor of ``local``: sharded as ``dims`` says, a partial sum
        over the other splitting dims except the mesh axes in ``reduced``."""
        pl = list(self.placements(dims or {}))
        done = {self.names.index(a) for a in reduced}
        for i in self.split:
            if isinstance(pl[i], Replicate) and i not in done:
                pl[i] = Partial()
        return DTensor.from_local(local, self.mesh, tuple(pl), run_check=False)

    def coord(self, axis: str) -> int:
        return self.mesh.get_local_rank(self.names.index(axis))


def _ctx():
    pair = active()
    if pair is None:
        raise RuntimeError("no active mesh (models.sharding.activation_sharding)")
    return pair


def _tp(mesh, rules) -> "tuple[str | None, int]":
    """The tensor-parallel mesh axis (the rules' ``"heads"`` axis present in
    the mesh) and its size; ``(None, 1)`` without one."""
    names = tuple(mesh.mesh_dim_names)
    for ax in rules.mesh_axes("heads"):
        if ax in names:
            return ax, mesh.size(names.index(ax))
    return None, 1


def _batch_axes(mesh, rules, batch: int) -> tuple:
    """The mesh axes the batch dim is sharded over (the rules' ``"batch"``
    axes present in the mesh that divide it)."""
    entry = logical_to_spec(("batch",), (batch,), mesh, rules)
    if not entry or entry[0] is None:
        return ()
    return (entry[0],) if isinstance(entry[0], str) else tuple(entry[0])


def _split_over(tp_axis, n: int, tp: int) -> bool:
    """Whether a block divides ``n`` heads / columns / experts over the model
    axis: whenever they divide it, as the rules shard them (a size-1 axis
    included, so the layouts equal the stored placements)."""
    return tp_axis is not None and n % tp == 0


def _local(mesh, rules, batch: int, tp_axis, tp_split: bool):
    axes = set(_batch_axes(mesh, rules, batch))
    if tp_split:
        axes.add(tp_axis)
    return _Local(mesh, axes), _batch_axes(mesh, rules, batch)


def _group(mesh, axis: str):
    return mesh.get_group(tuple(mesh.mesh_dim_names).index(axis))


class _AllReduceSum(torch.autograd.Function):
    """A sum over a process group whose adjoint is the sum of the
    gradients (each rank's output is a separate use of the total)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# -- embedding, norm ----------------------------------------------------------------------


def embed_tokens(model, cfg, batch: dict, compute_dtype) -> DTensor:
    """Vocab-parallel embedding: each rank looks up the tokens of its
    vocabulary rows and writes zeros elsewhere, a partial sum over
    ``"model"`` that the caller's anchor reduces (exact: one nonzero
    term a row).  Audio sums its codebooks' lookups; a VLM's image
    embeddings go in front on the first model rank only."""
    mesh, rules = _ctx()
    tokens = batch["tokens"]
    B = tokens.shape[0]
    tp_axis, tp = _tp(mesh, rules)
    split = _split_over(tp_axis, cfg.vocab, tp)
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    tok = loc.arg(tokens, bd).long()
    vdim = 1 if cfg.modality == "audio" else 0  # [K, V, d] codebook tables
    emb = loc.arg(model.embed, {vdim: tp_axis} if split else {})
    n = emb.shape[vdim]
    lo = loc.coord(tp_axis) * n if split else 0
    zero = torch.zeros((), dtype=compute_dtype, device=tok.device)

    def lookup(table, t):
        t = t - lo
        rows = table[t.clamp(0, n - 1)].to(compute_dtype)
        return torch.where(((t >= 0) & (t < n))[..., None], rows, zero)

    if cfg.modality == "audio":
        x = torch.zeros((tok.shape[0], tok.shape[2], cfg.d_model), dtype=compute_dtype,
                        device=tok.device)
        for kb in range(cfg.num_codebooks):
            x = x + lookup(emb[kb], tok[:, kb])
    else:
        x = lookup(emb, tok)
        if cfg.modality == "vlm" and "image_embeds" in batch:
            img = loc.arg(batch["image_embeds"], bd).to(compute_dtype)
            if split and loc.coord(tp_axis) != 0:
                img = torch.zeros_like(img)
            x = torch.cat([img, x], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype, device=x.device)
    return loc.out(x, bd)


def rms_norm_rows(x: DTensor, scale: DTensor, eps: float) -> DTensor:
    """``layers.rms_norm`` on the local rows of ``x`` (sharded over batch
    and sequence, never over the last dim); the scale's gradient is a
    partial sum over every dim ``x`` is sharded over."""
    mesh, _ = _ctx()
    names = tuple(mesh.mesh_dim_names)
    if any(isinstance(p, Partial) for p in x.placements):
        raise ValueError("rms_norm_rows takes a reduced activation")
    dims = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(names[i])
    loc = _Local(mesh, {a for axes in dims.values() for a in axes})
    dims = {d: tuple(a) for d, a in dims.items()}
    y = rms_norm(loc.arg(x, dims), loc.arg(scale), eps)
    return loc.out(y, dims)


# -- blocks ------------------------------------------------------------------------------


def _kv_slice(H: int, KV: int, tp: int, rank: int) -> tuple[int, int]:
    """The kv heads the query heads of ``rank`` read, when the kv heads
    do not divide the model axis (GQA: query head h reads kv head h // (H /
    KV))."""
    G = H // KV
    Hl = H // tp
    if Hl % G and G % Hl:
        raise NotImplementedError(f"{H} query heads over {tp} ranks straddle the kv groups "
                                  f"of {G}")
    lo = rank * Hl // G
    return lo, ((rank + 1) * Hl - 1) // G + 1


def _cache_arg(loc, t: DTensor, dims: dict) -> torch.Tensor:
    """A cache leaf is written in place: it must already be in the layout
    the local computation needs."""
    if tuple(t.placements) != loc.placements(dims):
        raise NotImplementedError(f"a cache leaf in {t.placements}: the block needs "
                                  f"{loc.placements(dims)}")
    return t.to_local()


class _Seq:
    """How a per-layer cache leaf ``[B, T, ...]`` is split along its
    sequence (``SERVE_RULES``' ``kv_seq``: the batch axes the batch leaves
    free): the mesh axes its rows lie over (mesh-dim order, the first the
    major one, as DTensor splits them; ``()`` when whole), the capacity
    ``total``, the ``rows`` of a shard and this shard's first row ``lo``."""

    def __init__(self, loc, t: DTensor):
        self.axes = tuple(loc.names[i] for i, p in enumerate(t.placements) if p == Shard(1))
        n, index = 1, 0
        for ax in self.axes:
            size = loc.mesh.size(loc.names.index(ax))
            n, index = n * size, index * size + loc.coord(ax)
        self.total = t.shape[1]
        self.rows = self.total // n
        self.lo = index * self.rows

    def owns(self, slot: int) -> bool:
        return self.lo <= slot < self.lo + self.rows


def _kv_cache_args(loc, cache: dict, dims: dict) -> "tuple[dict, _Seq]":
    """The local shards of a KV / MLA cache's leaves ``[B, T, ...]``, laid
    out as ``dims`` and, along the sequence, as the leaves are (one
    :class:`_Seq` for all of them)."""
    seq = _Seq(loc, next(iter(cache.values())))
    full = {**dims, 1: seq.axes} if seq.axes else dims
    return {key: _cache_arg(loc, t, full) for key, t in cache.items()}, seq


def _head_dim_sharded(t: DTensor, mesh, tp_axis) -> bool:
    """Whether a per-layer KV cache leaf ``[B, T, KV, Dh]`` is split over
    the model axis along ``head_dim`` (``SERVE_RULES`` when the kv heads do
    not divide that axis)."""
    return (tp_axis is not None
            and t.placements[tuple(mesh.mesh_dim_names).index(tp_axis)] == Shard(t.dim() - 1))


def _all_reduce(t: torch.Tensor, loc, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the mesh ``axes``, one all-reduce an axis (no
    gradient: :class:`_AllReduceSum` has one)."""
    t = t.contiguous()
    for ax in axes:
        dist.all_reduce(t, op=op, group=_group(loc.mesh, ax))
    return t


def _gather_dim(loc, local: torch.Tensor, dims: dict, axis, dim: int) -> torch.Tensor:
    """The whole of tensor dim ``dim``, whose slices lie over ``axis`` (a
    mesh axis, or a tuple of them, the first the major one: an all-gather
    over each), laid out as ``dims`` otherwise."""
    dt = DTensor.from_local(local, loc.mesh, loc.placements({**dims, dim: axis}), run_check=False)
    return dt.redistribute(loc.mesh, loc.placements(dims)).to_local()


def _cache_rows(loc, local: torch.Tensor, dims: dict, seq: _Seq, ci: int,
                split=None) -> torch.Tensor:
    """The rows ``0 .. ci`` of a cache leaf whose shard is laid out as
    ``dims`` besides its sequence, whole along ``dim`` too with ``split =
    (axis, dim)`` (``dims`` puts ``dim`` over ``axis``): the rows a prefill
    from ``cache_index = ci`` attends over.  Along the sequence only each
    shard's first ``min(rows, ci)`` rows are gathered: the rows below ``ci``
    fill the first shards, and lie in the first one when ``ci`` is below a
    shard's rows."""
    if seq.axes:
        local = _gather_dim(loc, local[:, :min(seq.rows, ci)].contiguous(), dims, seq.axes, 1)
    if split:
        axis, dim = split
        local = _gather_dim(loc, local, {d: a for d, a in dims.items() if d != dim}, axis, dim)
    return local[:, :ci]


def _write_rows(dst: torch.Tensor, src: torch.Tensor, first: int, seq: _Seq) -> None:
    """``src``'s rows (dim 1), the positions ``first ..``, written into the
    rows of ``dst`` that this shard owns."""
    a, z = max(first, seq.lo), min(first + src.shape[1], seq.lo + seq.rows)
    if a < z:
        dst[:, a - seq.lo:z - seq.lo] = src[:, a - first:z - first]


def _write_ring(dst: torch.Tensor, src: torch.Tensor, seq: _Seq) -> None:
    """A ring cache's prefill (positions ``0 .. S-1``, the last ``W`` of
    them at slots ``p % W``, as ``attention.attn_block_full``): the slots
    this shard owns, each the last position that maps to it."""
    S, W = src.shape[1], seq.total
    if S <= W:  # no wrap: slot p holds position p
        _write_rows(dst, src, 0, seq)
        return
    slots = torch.arange(seq.lo, seq.lo + seq.rows, device=dst.device)
    dst.copy_(src[:, (slots - (S - W)) % W + (S - W)])


def _decode_probs(loc, s: torch.Tensor, index: int, window: int, attn_softcap, dtype,
                  seq: _Seq) -> torch.Tensor:
    """``attention.decode_probs`` on the scores of this shard's cache rows
    when the cache is split along its sequence: each row masked at its
    global position, the max and then the sum of exponentials all-reduced
    over the sequence's axes, and each shard's normalized probabilities
    rounded to ``dtype`` (the reference's rounding point: no rescaled
    flash-decoding sum)."""
    if not seq.axes:
        return attn.decode_probs(s, index, window, attn_softcap, dtype)
    s = attn.decode_scores(s, index, window, attn_softcap, first=seq.lo)
    m = _all_reduce(s.amax(dim=-1, keepdim=True), loc, seq.axes, dist.ReduceOp.MAX)
    e = torch.exp(s - m)
    return (e / _all_reduce(e.sum(dim=-1, keepdim=True), loc, seq.axes)).to(dtype)


def _attend_cache(loc, bd: dict, cd: dict, pl, h, cfg, bdef, c: dict, seq: _Seq, ci: int, mode,
                  engine, hd_axis=None) -> torch.Tensor:
    """Attention of ``h`` (the normed input, ``[b, S, d]``; q / k / v
    projected on the heads ``pl`` holds) against a KV cache whose local
    shards ``c`` (laid out as ``cd`` besides the sequence) are split along
    the sequence (``seq``) and / or, with ``hd_axis``, along ``head_dim``
    over that axis (each rank holding every kv head's ``Dh / tp`` columns).
    Returns ``[b, S, H, Dh]``, whole on every rank of those axes.

    * Prefill runs the flash kernel over the fresh k / v rounded through the
      cache's dtype, which is what the cache would hand back (a ring cache
      attends over the fresh k / v, as the one-device block does); each rank
      writes the rows (ring slots) and ``head_dim`` columns its shard owns.
      Rows already cached (``cache_index > 0``) are gathered first.
    * Decode: the owner of the position (or its ring slot) writes the new
      row.  Each rank scores q against its own rows in float32; a
      ``head_dim`` split sums the partial scores over its axis (GSPMD's
      contraction in the reference: ``4 B H T`` bytes a layer, where
      gathering the layer's cache would move ``2 B T KV Dh`` elements).  The
      softmax is :func:`_decode_probs`, ``P v`` runs on the local rows and
      one all-reduce over the sequence's axes sums the shards' ``P v``: three
      small collectives a layer, the reference's function.  A ``head_dim``
      split then all-gathers the output's column slices."""
    bl, S = h.shape[0], h.shape[1]
    dtype = c["k"].dtype
    Dl = c["k"].shape[3]
    lo = loc.coord(hd_axis) * Dl if hd_axis else 0
    cols = slice(lo, lo + Dl)
    ring = attn._is_ring(bdef, seq.total)
    if mode == "decode":
        positions = torch.full((bl, 1), ci, dtype=torch.int32, device=h.device)
        q, k, v = attn._project_qkv(pl, h, cfg, positions, h.dtype)
        slot, window = (ci % seq.total, -1) if ring else (ci, bdef.window)
        if seq.owns(slot):
            c["k"][:, slot - seq.lo] = k[:, 0, :, cols].to(dtype)
            c["v"][:, slot - seq.lo] = v[:, 0, :, cols].to(dtype)
        H, D = q.shape[2], q.shape[3]
        KV = c["k"].shape[2]
        qg = q[..., cols].reshape(bl, KV, H // KV, Dl)
        s = torch.einsum("bkgd,btkd->bkgt", qg.float(), c["k"].float())
        if hd_axis:
            s = _all_reduce(s, loc, (hd_axis,))
        probs = _decode_probs(loc, s * (1.0 / math.sqrt(D)), ci, window, cfg.attn_softcap,
                              q.dtype, seq)
        o = _all_reduce(torch.einsum("bkgt,btkd->bkgd", probs.float(), c["v"].float()), loc,
                        seq.axes)
        o = o.to(torch.promote_types(q.dtype, dtype)).reshape(bl, 1, H, Dl)
        return _gather_dim(loc, o, bd, hd_axis, 3) if hd_axis else o
    positions = (torch.arange(S, device=h.device) + ci).expand(bl, S)
    q, k, v = attn._project_qkv(pl, h, cfg, positions, h.dtype)
    kw = dict(window=bdef.window, attn_softcap=cfg.attn_softcap, engine=engine,
              q_chunk=cfg.q_chunk)
    kc, vc = k.to(dtype), v.to(dtype)
    if ring:  # prefill from 0, as the one-device block
        _write_ring(c["k"], kc[..., cols], seq)
        _write_ring(c["v"], vc[..., cols], seq)
        return attn.attention_full(q, k, v, **kw)
    _write_rows(c["k"], kc[..., cols], ci, seq)
    _write_rows(c["v"], vc[..., cols], ci, seq)
    if ci:
        split = (hd_axis, 3) if hd_axis else None
        kc = torch.cat([_cache_rows(loc, c["k"], cd, seq, ci, split), kc], dim=1)
        vc = torch.cat([_cache_rows(loc, c["v"], cd, seq, ci, split), vc], dim=1)
    return attn.attention_full(q, kc, vc, q_offset=ci, kv_len=ci + S, **kw)


def _attn_head_dim(bdef, p, x: DTensor, cfg, cache, cache_index, mode, engine, tp_axis) -> DTensor:
    """ln1 + attention with the KV cache split over the model axis along
    ``head_dim`` (each rank holds every kv head's slice ``Dh / tp``; its rows
    perhaps split along the sequence too).  The block runs whole on every
    rank (its weights gathered, as when the heads do not split): the
    projections and rope need the whole head (:func:`_attend_cache`).  The
    output is replicated over the model axis, as the block's work is."""
    mesh, rules = _ctx()
    B = x.shape[0]
    loc, baxes = _local(mesh, rules, B, tp_axis, False)
    bd = {0: baxes} if baxes else {}
    cd = {**bd, 3: tp_axis}
    c, seq = _kv_cache_args(loc, cache, cd)
    xl = loc.arg(x, bd)
    pa = p.attn
    pl = SimpleNamespace(wq=loc.arg(pa.wq), wk=loc.arg(pa.wk), wv=loc.arg(pa.wv),
                         wo=loc.arg(pa.wo))
    h = rms_norm(xl, loc.arg(p.ln1), cfg.norm_eps)
    o = _attend_cache(loc, bd, cd, pl, h, cfg, bdef, c, seq, cache_index or 0, mode, engine,
                      hd_axis=tp_axis)
    return loc.out(attn._out_proj(pl, o, xl.dtype), bd)


def _attn(bdef, p, x: DTensor, cfg, cache, cache_index, mode, engine) -> DTensor:
    """ln1 + attention over this rank's heads; a partial sum over the model
    axis (the flash-attention kernel runs on the local heads).  A cache
    split along ``head_dim`` takes :func:`_attn_head_dim`; one split along
    its sequence takes :func:`_attend_cache` on the local heads."""
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    if cache is not None and _head_dim_sharded(cache["k"], mesh, tp_axis):
        return _attn_head_dim(bdef, p, x, cfg, cache, cache_index, mode, engine, tp_axis)
    B, S = x.shape[0], x.shape[1]
    H, KV = cfg.n_heads, cfg.n_kv_heads
    split = _split_over(tp_axis, H, tp)
    kv_split = split and KV % tp == 0
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    xl = loc.arg(x, bd)
    ln1 = loc.arg(p.ln1)
    wq = loc.arg(p.attn.wq, {1: tp_axis} if split else {})
    wo = loc.arg(p.attn.wo, {0: tp_axis} if split else {})
    wk = loc.arg(p.attn.wk, {1: tp_axis} if kv_split else {})
    wv = loc.arg(p.attn.wv, {1: tp_axis} if kv_split else {})
    if split and not kv_split:
        lo, hi = _kv_slice(H, KV, tp, loc.coord(tp_axis))
        wk, wv = wk[:, lo:hi], wv[:, lo:hi]
    c = None
    if cache is not None:
        cd = dict(bd)
        if kv_split:
            cd[2] = tp_axis
        elif split:
            raise NotImplementedError("a KV cache whose kv heads do not divide the model axis")
        c, seq = _kv_cache_args(loc, cache, cd)
    h = rms_norm(xl, ln1, cfg.norm_eps)
    pl = SimpleNamespace(wq=wq, wk=wk, wv=wv, wo=wo)
    if c is not None and seq.axes:
        o = attn._out_proj(pl, _attend_cache(loc, bd, cd, pl, h, cfg, bdef, c, seq,
                                             cache_index or 0, mode, engine), xl.dtype)
    elif mode == "decode":
        o, _ = attn.attn_block_decode(pl, h, cfg, bdef, c, cache_index)
    else:
        positions = (torch.arange(S, device=xl.device) + (cache_index or 0)).expand(xl.shape[0], S)
        o, _ = attn.attn_block_full(pl, h, cfg, bdef, positions, cache=c,
                                    cache_index=cache_index, engine=engine)
    return loc.out(o, bd)


def _mla(bdef, p, x: DTensor, cfg, cache, cache_index, mode) -> DTensor:
    """ln1 + multi-head latent attention over this rank's heads (train
    mode): the latent ``c_kv`` and the shared rope key are computed on
    every rank from the replicated down-projections, the query, ``w_uk``,
    ``w_uv`` and output projections split by heads; a partial sum over the
    model axis.  With a cache: :func:`_mla_cache`."""
    if cache is not None:
        return _mla_cache(bdef, p, x, cfg, cache, cache_index or 0, mode)
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    B, S = x.shape[0], x.shape[1]
    split = _split_over(tp_axis, cfg.n_heads, tp)
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    hd = {1: tp_axis} if split else {}
    pa = p.attn
    pl = SimpleNamespace(wq=loc.arg(pa.wq, hd), w_dkv=loc.arg(pa.w_dkv),
                         kv_norm=loc.arg(pa.kv_norm), w_kr=loc.arg(pa.w_kr),
                         w_uk=loc.arg(pa.w_uk, hd), w_uv=loc.arg(pa.w_uv, hd),
                         wo=loc.arg(pa.wo, {0: tp_axis} if split else {}))
    xl = loc.arg(x, bd)
    h = rms_norm(xl, loc.arg(p.ln1), cfg.norm_eps)
    positions = torch.arange(S, device=xl.device).expand(xl.shape[0], S)
    local_cfg = dataclasses.replace(cfg, n_heads=pl.wq.shape[1])
    o, _ = attn.mla_block_full(pl, h, local_cfg, bdef, positions)
    return loc.out(o, bd)


def _mla_cache(bdef, p, x: DTensor, cfg, cache, ci: int, mode) -> DTensor:
    """ln1 + MLA with its cache as ``SERVE_RULES`` lay it out: ``c_kv [B,
    T, kv_lora]`` and ``k_rope [B, T, rope]`` both split over the model axis
    along their last dim (or neither), their rows perhaps split along the
    sequence.  The projections run whole on every rank (the weights
    gathered, as :func:`_attn_head_dim`'s); each rank writes its latent and
    rope columns of the rows it owns.

    * Prefill attends over the fresh whole ``c_kv`` / ``k_rope`` (rounded
      through the cache's dtype) with ``attention._mla_attend``'s ragged
      query chunks, rows already cached gathered first; the output is
      replicated over the model axis.
    * Decode contracts the split dims: ``q_nope @ w_uk`` over this rank's
      latent rows against its ``c_kv`` columns plus ``q_rope`` against its
      ``k_rope`` columns, float32 scores of compute-dtype operands (TF32
      off), one all-reduce over the model axis; the softmax
      (:func:`_decode_probs`, rounded to the compute dtype before ``P
      c_kv``); ``P c_kv`` on the local latent columns (summed over the
      sequence's axes) times the local rows of ``w_uv``: an output that is a
      partial sum over the model axis."""
    mesh, rules = _ctx()
    tp_axis, _ = _tp(mesh, rules)
    B, S = x.shape[0], x.shape[1]
    split = tp_axis is not None and cache["c_kv"].placements[
        tuple(mesh.mesh_dim_names).index(tp_axis)] == Shard(2)
    loc, baxes = _local(mesh, rules, B, tp_axis, split and mode == "decode")
    bd = {0: baxes} if baxes else {}
    cd = {**bd, 2: tp_axis} if split else dict(bd)
    c, seq = _kv_cache_args(loc, cache, cd)
    r = loc.coord(tp_axis) if split else 0
    Ll, Rl = c["c_kv"].shape[2], c["k_rope"].shape[2]
    lat, rot = slice(r * Ll, (r + 1) * Ll), slice(r * Rl, (r + 1) * Rl)
    pa = p.attn
    up = {0: tp_axis} if split and mode == "decode" else {}
    pl = SimpleNamespace(wq=loc.arg(pa.wq), w_dkv=loc.arg(pa.w_dkv), kv_norm=loc.arg(pa.kv_norm),
                         w_kr=loc.arg(pa.w_kr), w_uk=loc.arg(pa.w_uk, up),
                         w_uv=loc.arg(pa.w_uv, up), wo=loc.arg(pa.wo))
    xl = loc.arg(x, bd)
    h = rms_norm(xl, loc.arg(p.ln1), cfg.norm_eps)
    bl, cdt, dtype = xl.shape[0], xl.dtype, c["c_kv"].dtype
    if mode == "decode":
        positions = torch.full((bl, 1), ci, dtype=torch.int32, device=xl.device)
        q_nope, q_rope, c_new, r_new = attn._mla_qkv(pl, h, cfg, positions, cdt)
        if seq.owns(ci):
            c["c_kv"][:, ci - seq.lo] = c_new[:, 0, lat].to(dtype)
            c["k_rope"][:, ci - seq.lo] = r_new[:, 0, rot].to(dtype)
        ckv, kr = c["c_kv"].to(cdt), c["k_rope"].to(cdt)
        q_abs = torch.einsum("bshn,lhn->bshl", q_nope, pl.w_uk.to(cdt))
        with full_float32_matmul():
            s = torch.einsum("bqhl,btl->bhqt", q_abs.float(), ckv.float())
            s = s + torch.einsum("bqhk,btk->bhqt", q_rope[..., rot].float(), kr.float())
        if split:
            s = _all_reduce(s, loc, (tp_axis,))
        scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        probs = _decode_probs(loc, s * scale, ci, -1, None, cdt, seq)
        ctx = _all_reduce(torch.einsum("bhqt,btl->bqhl", probs.float(), ckv.float()), loc,
                          seq.axes).to(cdt)
        o = torch.einsum("bqhl,lhv->bqhv", ctx, pl.w_uv.to(cdt))
        return loc.out(attn._out_proj(pl, o, cdt), bd)
    positions = (torch.arange(S, device=xl.device) + ci).expand(bl, S)
    q_nope, q_rope, c_new, r_new = attn._mla_qkv(pl, h, cfg, positions, cdt)
    ckv, kr = c_new.to(dtype), r_new.to(dtype)
    _write_rows(c["c_kv"], ckv[..., lat], ci, seq)
    _write_rows(c["k_rope"], kr[..., rot], ci, seq)
    if ci:
        rows = (tp_axis, 2) if split else None
        ckv = torch.cat([_cache_rows(loc, c["c_kv"], cd, seq, ci, rows), ckv], dim=1)
        kr = torch.cat([_cache_rows(loc, c["k_rope"], cd, seq, ci, rows), kr], dim=1)
    o = attn._mla_attend(pl, q_nope, q_rope, ckv, kr, cfg, q_offset=ci, kv_len=ci + S,
                         compute_dtype=cdt, q_chunk=cfg.prefill_q_chunk)
    return loc.out(attn._out_proj(pl, o, cdt), bd)


def _ffn(bdef, p, x: DTensor, cfg):
    """ln2 + the FFN over this rank's width (or experts); returns ``(y, aux)``,
    ``y`` a partial sum over the model axis."""
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    B = x.shape[0]
    if bdef.ffn == "moe":
        return _moe(p, x, cfg, mesh, rules, tp_axis, tp)
    ff = bdef.d_ff or cfg.d_ff
    split = _split_over(tp_axis, ff, tp)
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    xl = loc.arg(x, bd)
    h = rms_norm(xl, loc.arg(p.ln2), cfg.norm_eps)
    col, row = ({1: tp_axis}, {0: tp_axis}) if split else ({}, {})
    w1, w2 = loc.arg(p.w1, col), loc.arg(p.w2, row)
    dt = xl.dtype
    if bdef.ffn == "gelu":
        y = F.gelu(h @ w1.to(dt), approximate="tanh") @ w2.to(dt)
    elif bdef.ffn == "geglu":
        w3 = loc.arg(p.w3, col)
        y = (F.gelu(h @ w1.to(dt), approximate="tanh") * (h @ w3.to(dt))) @ w2.to(dt)
    else:
        w3 = loc.arg(p.w3, col)
        y = (F.silu(h @ w1.to(dt)) * (h @ w3.to(dt))) @ w2.to(dt)
    return loc.out(y, bd), 0.0


def _moe(p, x: DTensor, cfg, mesh, rules, tp_axis, tp):
    """ln2 + a MoE FFN with this rank's experts.

    The function is the one-device ``moe_ffn`` of each microbatch: the
    batch, or under ``sharding.side_by_side`` each of the microbatches it
    holds, whose tokens lie over its own batch axes
    (:func:`_microbatch_axes`).  Every reduction that defines it runs over
    those axes only:

    * the Switch aux loss ``E * sum_e load_e * importance_e`` takes both
      means over the microbatch's tokens: the first-choice counts are summed
      over its axes (no gradient), and each rank returns its tokens' part of
      the importance term, divided by the model axis's size because every
      rank of it computes the same term — a partial sum over every
      splitting dim, whose gradient is then the whole one, and whose sum
      over the ranks is the sum of the side-by-side microbatches' terms;
    * the einsum dispatch runs the microbatch's groups, only the local
      experts' buffers filled; a group that the batch shards cut takes its
      choices from the microbatch's other shards (:func:`_cut_groups`);
    * the sort dispatch ranks each (token, choice) pair within its expert in
      the microbatch's token-major order against one capacity over its
      tokens: a pair's rank is its rank on this shard plus the pairs of its
      expert on the earlier shards, an exclusive scan of one ``[E]`` count
      vector a shard over the microbatch's axes (no token vector or routing
      choice moves).  The expert FFN is row-wise, so each rank runs its
      local experts on its own kept pairs only.  Each token combines its
      local experts' terms in ascending expert order, as ``_moe_sort`` does
      (two calls give the same bits); over the model axis the ranks'
      partial sums are then added by the collective that reduces the
      block's output, in its own order, so that the sum is held to the
      one-device path by tolerance."""
    B, S, d = x.shape
    E = cfg.moe_experts
    pm = p.moe
    split = _split_over(tp_axis, E, tp)
    if cfg.moe_shared_d_ff and split and cfg.moe_shared_d_ff % tp:
        raise NotImplementedError(f"shared experts of width {cfg.moe_shared_d_ff} over {tp} ranks")
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    maxes, k = _microbatch_axes(loc, baxes)
    bd = {0: baxes} if baxes else {}
    xl = loc.arg(x, bd)
    h = rms_norm(xl, loc.arg(p.ln2), cfg.norm_eps)
    ex = {0: tp_axis} if split else {}
    pl = SimpleNamespace(router=loc.arg(pm.router), w1=loc.arg(pm.w1, ex), w3=loc.arg(pm.w3, ex),
                         w2=loc.arg(pm.w2, ex))
    xt = h.reshape(-1, d)
    T = B * S // k  # the microbatch's tokens
    probs, w, idx = route(pl, xt, cfg)
    experts = None
    if split:
        lo = loc.coord(tp_axis) * (E // tp)
        experts = (lo, lo + E // tp)
    if cfg.moe_dispatch == "sort":
        before = None
        if maxes:
            counts = torch.zeros(E, dtype=torch.int64, device=xt.device).index_add_(
                0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
            every = _gather_dim(loc, counts[None], {}, maxes, 0)  # [shards, E]
            before = every[:_shard_index(loc, maxes)].sum(0)
        y = _moe_sort(pl, xt, w, idx, cfg, experts=experts, before=before, tokens=T)
    else:
        Sg = group_size(T, cfg)
        if xt.shape[0] % Sg:
            xp, wp, ip, off = _cut_groups(loc, maxes, xt, w, idx, Sg)
            y = _moe_einsum(pl, xp, wp, ip, cfg, experts=experts, group=Sg)[off:off + xt.shape[0]]
        else:
            y = _moe_einsum(pl, xt, w, idx, cfg, experts=experts, group=Sg)
    if cfg.moe_shared_d_ff:
        col, row = ({1: tp_axis}, {0: tp_axis}) if split else ({}, {})
        sw1, sw3, sw2 = loc.arg(pm.sw1, col), loc.arg(pm.sw3, col), loc.arg(pm.sw2, row)
        y = y + (F.silu(xt @ sw1.to(xt.dtype)) * (xt @ sw3.to(xt.dtype))) @ sw2.to(xt.dtype)
    counts = _all_reduce(F.one_hot(idx[:, 0], E).to(torch.float32).sum(0), loc, maxes)
    load = counts / T
    aux = E * torch.sum(load * (probs.sum(0) / T))
    if split:
        aux = aux / tp
    return loc.out(y.reshape(xl.shape), bd), loc.out(aux)


def _microbatch_axes(loc, baxes) -> "tuple[tuple, int]":
    """``(the batch axes one microbatch's rows lie over, in mesh order; the
    microbatches side by side)``: every batch axis for one microbatch, else
    the axes ``sharding.side_by_side`` carries (``train_loop._rows``' layout
    rule)."""
    layout = side_by_side_layout()
    if layout is None or layout.k == 1:
        return tuple(sorted(baxes, key=loc.names.index)), 1
    return layout.axes, layout.k


def _shard_index(loc, axes) -> int:
    """This rank's place among the shards over the mesh ``axes`` (in mesh
    order, the first the major one: DTensor's order of a dim's shards)."""
    shard = 0
    for ax in sorted(axes, key=loc.names.index):
        shard = shard * loc.mesh.size(loc.names.index(ax)) + loc.coord(ax)
    return shard


def _cut_groups(loc, axes, xt, w, idx, Sg: int):
    """This shard's tokens padded out to the einsum dispatch's groups they
    fall in, when the batch shards cut a group (a decode step's few tokens
    a rank).  A token's buffer position counts every earlier choice of its
    group, so the covering groups' choices are gathered over the
    microbatch's batch ``axes``; the other shards' tokens enter as zero rows
    of zero weight, holding their slots.  Returns ``(x, w, idx, offset of
    the own rows)``."""
    axes = tuple(sorted(axes, key=loc.names.index))
    T = xt.shape[0]
    first = _shard_index(loc, axes) * T
    g0, g1 = first // Sg, -(-(first + T) // Sg)
    lo, hi = first - g0 * Sg, g1 * Sg - first - T
    choices = _gather_dim(loc, idx, {}, axes, 0)[g0 * Sg:g1 * Sg]

    def pad(t):
        return torch.cat([t.new_zeros((lo, t.shape[1])), t, t.new_zeros((hi, t.shape[1]))])

    return pad(xt), pad(w), choices, lo


def _norm_split(loc, x: torch.Tensor, scale: torch.Tensor, eps: float, axis,
                width: int) -> torch.Tensor:
    """``layers.rms_norm`` of ``x`` whose last dim is a slice of one of
    ``width`` split over the mesh ``axis`` (``None``: whole): the sum of
    squares all-reduced there."""
    x32 = x.to(torch.float32)
    ss = torch.sum(x32 * x32, dim=-1, keepdim=True)
    if axis is not None:
        ss = _AllReduceSum.apply(ss, _group(loc.mesh, axis))
    y = x32 * torch.rsqrt(ss / width + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def _mamba2(p, x: DTensor, cfg, engine, cache=None, mode="train") -> DTensor:
    """A mamba2 block over this rank's heads: the in-projection and conv
    columns of the local heads and of the B / C groups they read, the SSD
    kernel on the local heads (decode: the recurrent step), the gated RMS
    norm over all heads (its sum of squares all-reduced over the model
    axis), the local rows of the out-projection; a partial sum over the
    model axis.

    A cache (prefill, decode) is ``SERVE_RULES``' layout: the SSD state
    ``[B, H, P, N]`` with heads over the model axis, contiguous as the
    local heads are, so the kernel takes the local shard as its initial
    state and its final state is written back in place.  The conv cache
    ``[B, K-1, C]`` is split in contiguous columns, which are not the
    columns the local heads read (their x columns plus their groups' B / C
    columns): it is gathered over the model axis (``B x (K-1) x C``
    float32, tiny), the conv runs on the local heads' columns, and each rank
    writes its own columns of the new window, the last K-1 conv inputs (old
    rows where the input is shorter), projecting the input's last rows onto
    them."""
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    b, S, d = x.shape
    di, H, G, N = m2._dims(cfg)
    P = cfg.ssm_head_dim
    split = _split_over(tp_axis, H, tp)
    loc, baxes = _local(mesh, rules, b, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    hd = {0: tp_axis} if split else {}
    xl = loc.arg(x, bd)
    w_in, conv_w, conv_b = loc.arg(p.w_in), loc.arg(p.conv_w), loc.arg(p.conv_b)
    A_log, D, dt_bias = loc.arg(p.A_log, hd), loc.arg(p.D, hd), loc.arg(p.dt_bias, hd)
    out_norm, w_out = loc.arg(p.out_norm, hd), loc.arg(p.w_out, hd)
    rep = H // G
    lo, hi = 0, H
    if split:
        lo = loc.coord(tp_axis) * (H // tp)
        hi = lo + H // tp
    Hl = hi - lo
    if Hl % rep and rep % Hl:
        raise NotImplementedError(f"{Hl} local heads straddle the B / C groups of {rep} heads")
    g_lo, g_hi = lo // rep, (hi - 1) // rep + 1
    dev = xl.device

    def cols(*spans):
        return torch.cat([torch.arange(a, z, device=dev) for a, z in spans])

    gn = (g_lo * N, g_hi * N)
    in_cols = cols((lo * P, hi * P), (di + lo * P, di + hi * P), (2 * di + gn[0], 2 * di + gn[1]),
                   (2 * di + G * N + gn[0], 2 * di + G * N + gn[1]),
                   (2 * di + 2 * G * N + lo, 2 * di + 2 * G * N + hi))
    conv_cols = cols((lo * P, hi * P), (di + gn[0], di + gn[1]),
                     (di + G * N + gn[0], di + G * N + gn[1]))
    dl, gl = Hl * P, (g_hi - g_lo) * N
    dtype = xl.dtype
    state = conv = conv_all = None
    if cache is not None:
        state = _cache_arg(loc, cache["state"], {**bd, 1: tp_axis} if split else bd)
        conv_split = (tp_axis is not None and
                      cache["conv"].placements[loc.names.index(tp_axis)] == Shard(2))
        conv = _cache_arg(loc, cache["conv"], {**bd, 2: tp_axis} if conv_split else bd)
        conv_all = _gather_dim(loc, conv, bd, tp_axis, 2) if conv_split else conv
    xn = rms_norm(xl, loc.arg(p.norm), cfg.norm_eps)
    proj = xn @ w_in[:, in_cols].to(dtype)
    z, conv_in, dt_raw = proj[..., :dl], proj[..., dl:2 * dl + 2 * gl], proj[..., 2 * dl + 2 * gl:]
    conved, _ = m2._causal_conv(conv_in, conv_w[:, conv_cols].to(dtype),
                                conv_b[conv_cols].to(dtype),
                                None if conv is None else conv_all[..., conv_cols])
    bl = xl.shape[0]
    xh = conved[..., :dl].reshape(bl, S, Hl, P)
    Bm = conved[..., dl:dl + gl].reshape(bl, S, g_hi - g_lo, N)
    Cm = conved[..., dl + gl:].reshape(bl, S, g_hi - g_lo, N)
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    if mode == "decode":  # the recurrent step on the local heads
        y, new = m2.ssd_step(state, xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        state.copy_(new)
    else:
        y, final = m2.ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, initial_state=state,
                                  engine=engine)
        if state is not None:
            state.copy_(final)
    if conv is not None:  # this rank's columns of the new window: the last K-1 conv inputs
        width, K1 = conv.shape[2], conv.shape[1]
        c0 = loc.coord(tp_axis) * width if conv_split else 0
        rows = xn[:, max(S - K1, 0):] @ w_in[:, di + c0:di + c0 + width].to(dtype)
        conv.copy_(torch.cat([conv_all[:, :, c0:c0 + width].to(dtype), rows], dim=1)[:, -K1:])
    y = y + xh.to(torch.float32) * D.to(torch.float32)[:, None]
    yf = _norm_split(loc, y.reshape(bl, S, dl).to(dtype), out_norm, cfg.norm_eps,
                     tp_axis if split else None, di)
    return loc.out((yf * F.silu(z)) @ w_out.to(dtype), bd)


def _sharded_along(t: DTensor, loc, axis, dim: int) -> bool:
    """Whether ``t`` is split over the mesh ``axis`` along tensor dim ``dim``."""
    return axis is not None and t.placements[loc.names.index(axis)] == Shard(dim)


def _heads(loc, tp_axis, tp: int, H: int, split: bool) -> tuple[int, int]:
    """The heads ``[lo, hi)`` this rank computes: its shard's, or all."""
    if not split:
        return 0, H
    lo = loc.coord(tp_axis) * (H // tp)
    return lo, lo + H // tp


def _mlstm(p, x: DTensor, cfg, cache, mode) -> DTensor:
    """An mLSTM block.  Where the heads divide the model axis, over this
    rank's heads (Megatron): their xc and z columns of ``w_up`` (gathered),
    their ``wq`` / ``wk`` / ``b_f``, the gates' products over the local xc
    rows of ``w_if`` summed over the model axis (``B S 2 H`` float32: each
    head's gates read all of xc) and their i / f columns kept, the parallel
    form and the fold on the local heads, ``out_norm``'s RMS over
    all of ``di`` (its sum of squares all-reduced over the model axis), the
    local rows of ``w_down``; a partial sum over the model axis.  The cache
    ``C`` / ``n`` / ``m`` is the local heads' shard, written in place.

    Elsewhere the block runs whole on every rank (its weights gathered) and
    its output is replicated over the model axis.  A cache split along
    ``head_dim`` (``SERVE_RULES``) stays so: this rank holds the key rows
    ``[r0, r1)`` of ``C`` (dim 2) and of ``n``, ``m`` whole.  The fold
    writes them from its slice of ``k`` (no collective); a decode step
    updates them and all-reduces the partial ``q . C`` and ``q . n`` over
    the model axis (``B H (D + 1)`` float32) before the division.

    The output of a prefill ignores the incoming state, as the one-device
    block's (the parallel form over the prompt alone)."""
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    B = x.shape[0]
    H = cfg.n_heads
    di = cfg.ssm_proj_factor * cfg.d_model
    D = di // H
    split = _split_over(tp_axis, H, tp)
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    hd = {0: tp_axis} if split else {}
    lo, hi = _heads(loc, tp_axis, tp, H, split)
    xl_ = loc.arg(x, bd)
    w_up = loc.arg(p.w_up)
    gate_sum = None
    if split:
        dev = xl_.device
        w_up = w_up[:, torch.cat([torch.arange(lo * D, hi * D, device=dev),
                                  torch.arange(di + lo * D, di + hi * D, device=dev)])]

        def gate_sum(g):  # every head's gates read all of xc: sum the local rows' products
            g = _AllReduceSum.apply(g.float(), _group(mesh, tp_axis)).to(g.dtype)
            return torch.cat([g[..., lo:hi], g[..., H + lo:H + hi]], dim=-1)

    pl = SimpleNamespace(w_up=w_up, wq=loc.arg(p.wq, hd), wk=loc.arg(p.wk, hd),
                         w_if=loc.arg(p.w_if, hd), b_f=loc.arg(p.b_f, hd))
    state = rows = None
    if cache is not None:
        rows = not split and _sharded_along(cache["C"], loc, tp_axis, 2)
        kd = {**bd, 2: tp_axis} if rows else {**bd, 1: tp_axis} if split else bd
        state = {"C": _cache_arg(loc, cache["C"], kd), "n": _cache_arg(loc, cache["n"], kd),
                 "m": _cache_arg(loc, cache["m"], {**bd, 1: tp_axis} if split else bd)}
    xn = rms_norm(xl_, loc.arg(p.norm), cfg.norm_eps)
    q, k, v, z, logi, logf = xl._mlstm_qkvif(pl, xn, cfg, gate_sum)
    keys = slice(None)
    if rows:
        Dl = state["C"].shape[2]
        keys = slice(loc.coord(tp_axis) * Dl, (loc.coord(tp_axis) + 1) * Dl)
    if mode == "decode":
        combine = None
        if rows:
            def combine(numer, qn):
                both = _all_reduce(torch.cat([numer, qn[..., None]], dim=-1), loc, (tp_axis,))
                return both[..., :-1], both[..., -1]
        new, h = xl.mlstm_recurrent_step(state, q[..., keys], k[..., keys], v, logi, logf,
                                         combine=combine)
        xl._write(state, new)
    else:
        h = xl.mlstm_parallel(q, k, v, logi, logf, q_chunk=cfg.q_chunk)
        if state is not None:
            xl._write(state, xl.mlstm_fold(state, k[..., keys], v, logi, logf))
    bl, S = h.shape[0], h.shape[1]
    hf = _norm_split(loc, h.reshape(bl, S, -1), loc.arg(p.out_norm, hd), cfg.norm_eps,
                     tp_axis if split else None, di)
    out = (hf * F.silu(z)) @ loc.arg(p.w_down, hd).to(xl_.dtype)
    return loc.out(out, bd)


def _slstm(p, x: DTensor, cfg, cache, engine) -> DTensor:
    """An sLSTM block (train, prefill, and decode as ``S = 1``).  Where the
    heads divide the model axis, the sLSTM kernel runs on this rank's heads:
    their columns of ``w_zifo`` / ``b_zifo`` in each of the 4 gates
    (gathered, then indexed), ``r_zifo[:, lo:hi]``, the cache's shards over
    heads as the initial state and the final state written back in place
    (in training through ``SLSTMFunction``, the kernel forward and its
    written-out backward); ``out_norm``'s RMS over ``d`` (the sum of squares
    all-reduced over the model axis) and the local rows of ``w_out``; a
    partial sum over the model axis.

    Elsewhere the block runs whole on every rank, the kernel on all heads,
    and its output is replicated over the model axis.  A state split along
    ``head_dim`` (``SERVE_RULES``) is gathered over the model axis first
    (``c`` / ``n`` / ``h``, ``B H D`` float32 each; ``m`` is whole): the
    recurrence's ``h @ R`` reads whole heads at every step, so a split
    recurrence would cost a collective a step.  This rank's ``head_dim``
    slice of the final ``c`` / ``n`` / ``h`` and ``m`` whole are written
    back."""
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    B = x.shape[0]
    d, H = cfg.d_model, cfg.n_heads
    D = d // H
    split = _split_over(tp_axis, H, tp)
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    lo, hi = _heads(loc, tp_axis, tp, H, split)
    xl_ = loc.arg(x, bd)
    w_zifo, b_zifo = loc.arg(p.w_zifo), loc.arg(p.b_zifo)
    out_norm, w_out = loc.arg(p.out_norm), loc.arg(p.w_out)
    R = loc.arg(p.r_zifo, {1: tp_axis} if split else {})
    if split:
        cols = torch.cat([torch.arange(g * d + lo * D, g * d + hi * D, device=xl_.device)
                          for g in range(4)])
        w_zifo, b_zifo = w_zifo[:, cols], b_zifo[cols]
        out_norm, w_out = out_norm[lo * D:hi * D], w_out[lo * D:hi * D]
    bl, dt = xl_.shape[0], xl_.dtype
    local = gathered = None
    if cache is not None:
        hd_split = not split and _sharded_along(cache["c"], loc, tp_axis, 2)
        sd = {**bd, 1: tp_axis} if split else {**bd, 2: tp_axis} if hd_split else bd
        local = {key: _cache_arg(loc, cache[key], sd) for key in ("c", "n", "h")}
        local["m"] = _cache_arg(loc, cache["m"], {**bd, 1: tp_axis} if split else bd)
        state = dict(local)
        if hd_split:
            gathered = local["c"].shape[2]
            state.update({key: _gather_dim(loc, local[key], bd, tp_axis, 2)
                          for key in ("c", "n", "h")})
    else:  # the computed heads' empty state (``ssm_xlstm.empty_slstm_state``'s)
        f32, shape = torch.float32, (bl, hi - lo, D)
        state = {key: torch.zeros(shape, dtype=f32, device=xl_.device) for key in ("c", "n", "h")}
        state["m"] = torch.full(shape, -1e30, dtype=f32, device=xl_.device)
    xn = rms_norm(xl_, loc.arg(p.norm), cfg.norm_eps)
    zifo = xn @ w_zifo.to(dt) + b_zifo.to(dt)
    hs, final = xl._slstm_scan(SimpleNamespace(r_zifo=R), zifo, cfg, state, engine)
    if local is not None:
        if gathered:
            r0 = loc.coord(tp_axis) * gathered
            final = {key: t if key == "m" else t[..., r0:r0 + gathered]
                     for key, t in final.items()}
        xl._write(local, final)
    hn = _norm_split(loc, hs.to(dt), out_norm, cfg.norm_eps, tp_axis if split else None, d)
    return loc.out(hn @ w_out.to(dt), bd)


def apply_block(bdef, p, x: DTensor, cfg, cache, cache_index, mode, engine):
    """``transformer.apply_block`` on shards: ``(x_out, cache, aux)``; the
    cache's local shards are updated in place."""
    check_engine(engine, x.device)
    if bdef.kind in ("mamba2", "mlstm", "slstm"):
        if bdef.kind == "mamba2":
            o = _mamba2(p, x, cfg, engine, cache, mode)
        elif bdef.kind == "mlstm":
            o = _mlstm(p, x, cfg, cache, mode)
        else:
            o = _slstm(p, x, cfg, cache, engine)
        return x + o.redistribute(x.device_mesh, x.placements), cache, 0.0
    if bdef.kind == "mla":
        o = _mla(bdef, p, x, cfg, cache, cache_index, mode)
    elif bdef.kind == "attn":
        o = _attn(bdef, p, x, cfg, cache, cache_index, mode, engine)
    else:
        raise NotImplementedError(f"a sharded {bdef.kind} block")
    o = o.redistribute(x.device_mesh, x.placements)
    if bdef.post_norms:
        o = rms_norm_rows(o, p.pn1, cfg.norm_eps)
    x = x + o
    if bdef.ffn == "none":
        return x, cache, 0.0
    y, aux = _ffn(bdef, p, x, cfg)
    y = y.redistribute(x.device_mesh, x.placements)
    if bdef.post_norms:
        y = rms_norm_rows(y, p.pn2, cfg.norm_eps)
    return x + y, cache, aux


# -- vocab-parallel cross-entropy -------------------------------------------------------------


class _VocabParallelCE(torch.autograd.Function):
    """Per-token NLL over a vocabulary split across ``group``: each rank runs
    the cross-entropy kernel on its shard of ``W`` (labels outside the
    shard mapped to -1: no label logit there); the global logsumexp is a
    max / sum-exp all-reduce of the shards' ``lse``, and the label logit
    ``lse_s - nll_s`` comes from the shard that holds the label (the others
    contribute exact zeros).  The backward is the kernel's written-out
    backward with the global ``lse``: ``dW`` for the local shard, ``dx`` a
    partial sum over the shards."""

    @staticmethod
    def forward(ctx, x, w, labels, softcap, group, plain):
        fwd = crossentropy_lse_ref if plain else crossentropy_forward
        nll_s, lse_s = fwd(x, w, labels, softcap)
        if group is None:
            nll, lse = nll_s, lse_s
        else:
            m = lse_s.clone()
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            se = torch.exp(lse_s - m)
            dist.all_reduce(se, group=group)
            lse = m + torch.log(se)
            picked = lse_s - nll_s
            dist.all_reduce(picked, group=group)
            nll = lse - picked
        ctx.save_for_backward(x, w, labels, lse)
        ctx.softcap = softcap
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = crossentropy_backward(x, w, labels, lse, grad_nll, ctx.softcap)
        return dx, dw, None, None, None, None


def cross_entropy(x: DTensor, w_out: DTensor, labels: DTensor, *, final_softcap=None,
                  mask=None, engine: str = "auto") -> DTensor:
    """``layers.cross_entropy_chunked`` under an active mesh: the mean
    token NLL with the vocabulary split over the model axis
    (:class:`_VocabParallelCE`); a partial sum over the batch axes.  Under
    ``sharding.side_by_side`` each microbatch's mean is over its own
    tokens, and the sum over the ranks is the sum of the microbatches'
    losses."""
    mesh, rules = _ctx()
    check_engine(engine, x.device)
    B, S, D = x.shape
    V = w_out.shape[1]
    tp_axis, tp = _tp(mesh, rules)
    split = _split_over(tp_axis, V, tp)
    loc, baxes = _local(mesh, rules, B, tp_axis, split)
    bd = {0: baxes} if baxes else {}
    xl = loc.arg(x, bd).reshape(-1, D)
    wl = loc.arg(w_out, {1: tp_axis} if split else {})
    lab = loc.arg(labels, bd).reshape(-1).long()
    if split:
        lo = loc.coord(tp_axis) * wl.shape[1]
        lab = lab - lo
        lab = torch.where((lab >= 0) & (lab < wl.shape[1]), lab, torch.full_like(lab, -1))
    group = _group(mesh, tp_axis) if split else None
    nll = _VocabParallelCE.apply(xl, wl, lab, float(final_softcap or 0.0), group,
                                 engine == "torch")
    maxes, k = _microbatch_axes(loc, baxes)
    if mask is None:
        loss = nll.sum() / max(B // k * S, 1)
    else:  # a plain [B, S] mask, the same on every rank: this shard's rows of it
        m = local_shard(mask, mesh, loc.placements(bd)).reshape(-1).to(torch.float32)
        if k > 1:  # the rows of this rank's microbatch: the outer axes tell them apart
            j = _shard_index(loc, [a for a in baxes if a not in maxes])
            mask = mask[j * (B // k):(j + 1) * (B // k)]
        loss = (nll * m).sum() / torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    return loc.out(loss, reduced=(tp_axis,) if split else ())


# -- vocab-parallel logits --------------------------------------------------------------------


def logits_from_hidden(model, cfg, x: DTensor) -> DTensor:
    """``transformer.logits_from_hidden`` under an active mesh, as a local
    product: this rank's batch rows of ``x`` (whole ``d_model``) times its
    vocabulary shard of the head (the tied embedding's rows, or ``out``'s
    columns; per codebook for audio), float32 products of compute-dtype
    operands (TF32 off: the caller's), then the final softcap.  Returns a DTensor split
    over the model axis along the vocabulary: no rank holds a global
    chunk of the logits or of the head."""
    mesh, rules = _ctx()
    tp_axis, tp = _tp(mesh, rules)
    split = _split_over(tp_axis, cfg.vocab, tp)
    loc, baxes = _local(mesh, rules, x.shape[0], tp_axis, split)
    bd = {0: baxes} if baxes else {}
    audio = cfg.modality == "audio"
    xl = loc.arg(x, bd)
    if cfg.tie_embeddings:  # the embedding [V, d] ([K, V, d] audio)
        vdim = 1 if audio else 0
        w = loc.arg(model.embed, {vdim: tp_axis} if split else {}).transpose(-1, -2)
    else:  # out [d, V] ([K, d, V] audio)
        w = loc.arg(model.out, {2 if audio else 1: tp_axis} if split else {})
    w = w.to(xl.dtype).float()
    logits = torch.einsum("bsd,kdv->bksv", xl.float(), w) if audio else xl.float() @ w
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return loc.out(logits, {**bd, logits.dim() - 1: tp_axis} if split else bd)

"""Model assembly: embeddings -> (head blocks, stacked superblocks, tail
blocks) -> final norm -> LM head.

The model is a :class:`Transformer` (``nn.Module``) whose parameters carry the
reference's leaf names and shapes (``embed``, ``ln1``, ``attn.wq`` ``[d, H,
Dh]``, ..., ``final_norm``, ``out``).  The reference stacks each superblock
position's parameters along a leading ``n_superblocks`` axis and scans over
it; here layer ``l`` of position ``i`` is ``model.stack[l][str(i)]``, index
``l`` of that axis, so carrying weights across is a copy
(``models/transfer.py``).  The cache (KV tensors, and a mamba2 block's
float32 conv and state) keeps the reference's stacked layout and is updated
in place.

The dense attention family (GQA, sliding windows, softcaps, sandwich norms;
text, VLM and audio embeddings), the Mamba2 hybrid family (zamba2: mamba2
blocks through the SSD kernel, and one shared attention block whose
parameters ``model.shared`` serve every stack position marked ``shared``,
each repeat with its own KV cache) and the xLSTM family (xlstm: mLSTM blocks
in torch ops, sLSTM blocks through the sLSTM recurrence kernel; both with
float32 recurrent caches) and the MLA / MoE family (deepseek-v2-lite:
MLA blocks with a compressed ``c_kv`` / ``k_rope`` cache; qwen3-moe: GQA
through the flash-attention kernel; both with mixture-of-experts FFNs,
``models/moe.py``, whose load-balance loss ``forward`` sums) are ported for
serving and for training: ``forward`` builds an autograd graph in train
mode when the parameters require grad, and ``loss_fn`` is the reference's
mean-token cross-entropy through the fused cross-entropy kernel, plus
``moe_aux_coef`` x the aux loss.
"""

from __future__ import annotations

import math
from typing import Iterator

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import full_float32_matmul
from . import attention as attn
from . import mamba2 as m2
from . import ssm_xlstm as xl
from .config import BlockDef, ModelConfig
from .layers import (
    Spec,
    cross_entropy_chunked,
    gelu_mlp,
    init_tensor,
    rms_norm,
    softcap,
    spec_leaves,
    spec_logical,
    spec_map,
    spec_shapes,
    swiglu,
)
from . import tensor_parallel
from .moe import moe_ffn, moe_specs
from .sharding import active, carry_context, constrain

__all__ = [
    "Transformer",
    "param_specs",
    "block_specs",
    "init_model_params",
    "abstract_params",
    "params_logical",
    "named_params_logical",
    "cache_logical",
    "count_params",
    "count_active_params",
    "state_items",
    "init_items",
    "forward",
    "apply_block",
    "embed_tokens",
    "logits_from_hidden",
    "loss_fn",
    "init_cache",
]

MODES = ("train", "prefill", "decode")
#: the residual stream's logical axes: the anchor after the embedding and at
#: the top of each stacked superblock (sequence parallelism under TRAIN_RULES)
_RESIDUAL = ("batch", "seq", None)
#: blocks that norm their own input and add ``x + out``: (train / prefill, decode)
_RECURRENT_BLOCKS = {
    "mamba2": (m2.mamba2_block_full, m2.mamba2_block_decode),
    "mlstm": (xl.mlstm_block_full, xl.mlstm_block_decode),
    "slstm": (xl.slstm_block_full, xl.slstm_block_decode),
}


# -- parameter spec tree -------------------------------------------------------------------


def _ffn_specs(cfg: ModelConfig, bdef: BlockDef) -> dict:
    d = cfg.d_model
    ff = bdef.d_ff or cfg.d_ff
    std = 1.0 / math.sqrt(d)
    if bdef.ffn == "none":
        return {}
    if bdef.ffn == "moe":
        return {"moe": moe_specs(cfg)}
    if bdef.ffn == "gelu":
        return {
            "w1": Spec((d, ff), ("fsdp_embed", "mlp"), std=std),
            "w2": Spec((ff, d), ("mlp", "fsdp_embed"), std=1.0 / math.sqrt(ff)),
        }
    return {  # swiglu / geglu (gated)
        "w1": Spec((d, ff), ("fsdp_embed", "mlp"), std=std),
        "w3": Spec((d, ff), ("fsdp_embed", "mlp"), std=std),
        "w2": Spec((ff, d), ("mlp", "fsdp_embed"), std=1.0 / math.sqrt(ff)),
    }


def block_specs(cfg: ModelConfig, bdef: BlockDef) -> dict:
    if bdef.kind == "mamba2":
        return m2.mamba2_specs(cfg)
    if bdef.kind == "mlstm":
        return xl.mlstm_specs(cfg)
    if bdef.kind == "slstm":
        return xl.slstm_specs(cfg)
    specs: dict = {"ln1": Spec((cfg.d_model,), ("embed",), init="zeros")}
    specs["attn"] = attn.mla_specs(cfg) if bdef.kind == "mla" else attn.attn_specs(cfg)
    if bdef.ffn != "none":
        specs["ln2"] = Spec((cfg.d_model,), ("embed",), init="zeros")
        specs.update(_ffn_specs(cfg, bdef))
    if bdef.post_norms:
        specs["pn1"] = Spec((cfg.d_model,), ("embed",), init="zeros")
        if bdef.ffn != "none":
            specs["pn2"] = Spec((cfg.d_model,), ("embed",), init="zeros")
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree: ``stack`` leaves carry the leading
    ``n_superblocks`` axis."""
    d, V = cfg.d_model, cfg.vocab
    tree: dict = {}
    if cfg.modality == "audio":
        tree["embed"] = Spec((cfg.num_codebooks, V, d), (None, "vocab", "fsdp_embed"), init="embed")
    else:
        tree["embed"] = Spec((V, d), ("vocab", "fsdp_embed"), init="embed")
    if cfg.head_blocks:
        tree["head"] = {str(i): block_specs(cfg, b) for i, b in enumerate(cfg.head_blocks)}
    tree["stack"] = {
        str(i): {} if b.shared else spec_map(lambda s: s.stacked(cfg.n_superblocks),
                                              block_specs(cfg, b))
        for i, b in enumerate(cfg.superblock)
    }
    if cfg.tail_blocks:
        tree["tail"] = {str(i): block_specs(cfg, b) for i, b in enumerate(cfg.tail_blocks)}
    if cfg.has_shared_block:
        tree["shared"] = block_specs(cfg, cfg.shared_block)
    tree["final_norm"] = Spec((d,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        if cfg.modality == "audio":
            tree["out"] = Spec((cfg.num_codebooks, d, V), (None, "embed", "vocab"),
                               std=1.0 / math.sqrt(d))
        else:
            tree["out"] = Spec((d, V), ("embed", "vocab"), std=1.0 / math.sqrt(d))
    return tree


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's parameter tree as meta-device tensors in
    ``cfg.param_dtype`` (stacked leaves with their layer axis)."""
    return spec_shapes(param_specs(cfg), _dt(cfg.param_dtype))


def params_logical(cfg: ModelConfig) -> dict:
    """The reference's tree of logical axes (stacked leaves lead with
    ``"layers"``)."""
    return spec_logical(param_specs(cfg))


def named_params_logical(cfg: ModelConfig) -> dict:
    """``{model parameter name: logical axes}``: layer ``l`` of a stacked
    leaf (``stack.<l>.<rest>``) drops the leading ``"layers"`` axis."""
    out = {}
    for path, s in spec_leaves(param_specs(cfg)):
        if path[0] == "stack":
            rest = ".".join(path[1:])
            for layer in range(cfg.n_superblocks):
                out[f"stack.{layer}.{rest}"] = s.logical[1:]
        else:
            out[".".join(path)] = s.logical
    return out


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for _, s in spec_leaves(param_specs(cfg)))


def count_active_params(cfg: ModelConfig) -> int:
    """MoE-aware active parameter count (for MODEL_FLOPS = 6*N_active*D): a
    routed expert's leaves (``moe/w1``, ``w2``, ``w3``) count top_k / E of
    their size; the router and the shared experts count whole."""
    total = 0
    for path, s in spec_leaves(param_specs(cfg)):
        n = math.prod(s.shape)
        if "moe" in path and path[-1] in ("w1", "w2", "w3") and cfg.moe_experts:
            n = n * cfg.moe_top_k // cfg.moe_experts
        total += n
    return total


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


# -- the module ----------------------------------------------------------------------------------


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


class _Params(nn.Module):
    """Float32 parameters named and shaped after a spec dict; a nested dict
    becomes a child module of the same name."""

    def __init__(self, specs: dict, device):
        super().__init__()
        for key, s in specs.items():
            if isinstance(s, Spec):
                self.register_parameter(key, _param(s.shape, device))
            else:
                self.add_module(key, _Params(s, device))


class Transformer(nn.Module):
    """The float32 parameters of one model config, uninitialized (see
    :func:`init_model_params` and ``transfer.params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        specs = param_specs(cfg)
        per_layer = {i: spec_map(lambda s: Spec(s.shape[1:], s.logical[1:], s.init, s.std), sub)
                     for i, sub in specs["stack"].items()}
        self.embed = _param(specs["embed"].shape, device)
        for seg in ("head", "tail"):
            if seg in specs:
                self.add_module(seg, nn.ModuleDict(
                    {i: _Params(sub, device) for i, sub in specs[seg].items()}))
        self.stack = nn.ModuleList(
            nn.ModuleDict({i: _Params(sub, device) for i, sub in per_layer.items()})
            for _ in range(cfg.n_superblocks)
        )
        if "shared" in specs:
            self.shared = _Params(specs["shared"], device)
        self.final_norm = _param(specs["final_norm"].shape, device)
        if "out" in specs:
            self.out = _param(specs["out"].shape, device)

    def stack_block(self, layer: int, i: int) -> tuple[BlockDef, nn.Module]:
        """``(bdef, params)`` of position ``i`` of stacked superblock
        ``layer``: a ``shared`` position runs ``cfg.shared_block`` on
        ``self.shared``, as the reference's scan body does."""
        b = self.cfg.superblock[i]
        if b.shared:
            return self.cfg.shared_block, self.shared
        return b, self.stack[layer][str(i)]

    def blocks(self) -> Iterator[tuple[str, str, int, BlockDef, nn.Module]]:
        """``(segment, position, layer, bdef, params)`` in execution order;
        ``layer`` indexes the stacked cache (0 outside the stack)."""
        cfg = self.cfg
        for i, b in enumerate(cfg.head_blocks):
            yield "head", str(i), 0, b, self.head[str(i)]
        for layer in range(cfg.n_superblocks):
            for i in range(len(cfg.superblock)):
                yield "stack", str(i), layer, *self.stack_block(layer, i)
        for i, b in enumerate(cfg.tail_blocks):
            yield "tail", str(i), 0, b, self.tail[str(i)]


def state_items(path: tuple, value) -> Iterator[tuple[str, object]]:
    """The module-state names of one leaf of the reference's parameter tree:
    a ``stack`` leaf splits along its leading axis, one name per layer."""
    if path[0] == "stack":
        rest = ".".join(path[1:])
        for layer in range(value.shape[0]):
            yield f"stack.{layer}.{rest}", value[layer]
    else:
        yield ".".join(path), value


def init_items(cfg: ModelConfig, generator: torch.Generator,
               device) -> Iterator[tuple[str, torch.Tensor]]:
    """``(module-state name, float32 value)`` of every parameter, drawn from
    ``generator`` by the reference's rules (``layers.init_tensor``) leaf by
    leaf in ``spec_leaves`` order, a ``stack`` leaf one layer slice at a
    time (one draw a slice, layer order), so that no draw is larger than one
    layer of a leaf.  On a CPU generator a slice of a multiple of 16
    elements takes the bits of the whole leaf's draw (its normal fill works
    in blocks of 16); a CUDA generator's bits follow each draw's shape."""
    for path, s in spec_leaves(param_specs(cfg)):
        if path[0] == "stack":
            rest = ".".join(path[1:])
            for layer in range(s.shape[0]):
                yield f"stack.{layer}.{rest}", init_tensor(s, generator, device, s.shape[1:])
        else:
            yield ".".join(path), init_tensor(s, generator, device)


def init_model_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Transformer:
    """A :class:`Transformer` with random float32 weights drawn by
    :func:`init_items`.  ``device`` defaults to the generator's."""
    device = generator.device if device is None else torch.device(device)
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for name, value in init_items(cfg, generator, device):
            model.get_parameter(name).copy_(value)
    return model


# -- block application ------------------------------------------------------------------------


def _ffn_apply(p, x, cfg, bdef):
    aux = 0.0
    if bdef.ffn == "none":
        return torch.zeros_like(x), aux
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if bdef.ffn == "moe":
        y, aux = moe_ffn(p.moe, h, cfg)
    elif bdef.ffn == "gelu":
        y = gelu_mlp(h, p.w1, p.w2, x.dtype)
    elif bdef.ffn == "geglu":
        a = h @ p.w1.to(x.dtype)
        g = h @ p.w3.to(x.dtype)
        y = (torch.nn.functional.gelu(a, approximate="tanh") * g) @ p.w2.to(x.dtype)
    else:
        y = swiglu(h, p.w1, p.w3, p.w2, x.dtype)
    if bdef.post_norms:
        y = rms_norm(y, p.pn2, cfg.norm_eps)
    return y, aux


def apply_block(bdef: BlockDef, p, x, cfg, positions, cache, cache_index, mode, engine="auto"):
    """Returns (x_out, cache, aux_loss); the cache is updated in place.  A
    mamba2, mLSTM or sLSTM block norms its input itself (no ``ln1``) and has
    no FFN, as in the reference; ``aux_loss`` is a MoE FFN's load-balance
    loss (0.0 for any other block).  Under an active mesh the block runs on
    local shards (``tensor_parallel.apply_block``)."""
    if active() is not None:
        return tensor_parallel.apply_block(bdef, p, x, cfg, cache, cache_index, mode, engine)
    if bdef.kind in _RECURRENT_BLOCKS:
        full, decode = _RECURRENT_BLOCKS[bdef.kind]
        if mode == "decode":
            out, cache = decode(p, x, cfg, bdef, cache, cache_index)
        else:
            out, cache = full(p, x, cfg, bdef, positions, cache=cache, cache_index=cache_index,
                              engine=engine)
        return x + out, cache, 0.0
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if bdef.kind == "mla":  # no kernel: plain products on every engine
        if mode == "decode":
            o, cache = attn.mla_block_decode(p.attn, h, cfg, bdef, cache, cache_index)
        else:
            o, cache = attn.mla_block_full(p.attn, h, cfg, bdef, positions, cache=cache,
                                           cache_index=cache_index)
    elif mode == "decode":
        o, cache = attn.attn_block_decode(p.attn, h, cfg, bdef, cache, cache_index)
    else:
        o, cache = attn.attn_block_full(p.attn, h, cfg, bdef, positions, cache=cache,
                                        cache_index=cache_index, engine=engine)
    if bdef.post_norms:
        o = rms_norm(o, p.pn1, cfg.norm_eps)
    x = x + o
    y, aux = _ffn_apply(p, x, cfg, bdef)
    return x + y, cache, aux


# -- cache construction -------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=torch.bfloat16, device=None):
    """Cache dict matching the segment structure.  Stacked blocks carry a
    leading n_superblocks dim (layer ``l`` uses index ``l``; each repeat of a
    shared block has its own cache).  An attention block's KV cache is in
    ``dtype``, and so is an MLA block's ``c_kv`` and ``k_rope``; a mamba2
    block's conv and state, an mLSTM block's ``C``, ``n``,
    ``m`` and an sLSTM block's ``c``, ``n``, ``h``, ``m`` are float32."""

    def block_cache(b, n=None):
        if b.shared:
            b = cfg.shared_block
        if b.kind == "mamba2":
            c = m2.empty_mamba2_state(cfg, batch, device=device)
        elif b.kind == "mlstm":
            c = xl.empty_mlstm_state(cfg, batch, device=device)
        elif b.kind == "slstm":
            c = xl.empty_slstm_state(cfg, batch, device=device)
        elif b.kind == "mla":
            c = attn.empty_mla_cache(cfg, batch, capacity, dtype, device=device)
        else:
            c = attn.empty_kv_cache(cfg, batch, capacity, dtype, window=b.window, device=device)
        if n is None:
            return c
        return {key: t.unsqueeze(0).repeat(n, *([1] * t.dim())) for key, t in c.items()}

    cache: dict = {}
    if cfg.head_blocks:
        cache["head"] = {str(i): block_cache(b) for i, b in enumerate(cfg.head_blocks)}
    cache["stack"] = {str(i): block_cache(b, cfg.n_superblocks) for i, b in enumerate(cfg.superblock)}
    if cfg.tail_blocks:
        cache["tail"] = {str(i): block_cache(b) for i, b in enumerate(cfg.tail_blocks)}
    return cache


_CACHE_LOGICAL = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "c_kv": ("batch", "kv_seq", "kv_lora"),
    "k_rope": ("batch", "kv_seq", "head_dim"),
    "C": ("batch", "heads", "head_dim", None),
    "n": ("batch", "heads", "head_dim"),
    "m": ("batch", "heads"),
    "c": ("batch", "heads", "head_dim"),
    "h": ("batch", "heads", "head_dim"),
    "conv": ("batch", None, "mlp"),
    "state": ("batch", "heads", "head_dim", "state"),
}


def cache_logical(cache, path: tuple = ()) -> dict:
    """Logical axes for every cache leaf (a cache of tensors, meta ones
    included): the leaf's key picks the base axes, trimmed or extended with
    ``None`` to the leaf's rank (an sLSTM ``m`` / ``n`` has 3 dims, an mLSTM
    ``m`` 2); leaves under ``stack`` gain a leading ``"layers"``."""
    if isinstance(cache, dict):
        return {key: cache_logical(sub, (*path, key)) for key, sub in cache.items()}
    base = _CACHE_LOGICAL[path[-1]]
    in_stack = "stack" in path
    rank = cache.dim() - (1 if in_stack else 0)
    if len(base) > rank:
        base = base[:rank]
    elif len(base) < rank:
        base = base + (None,) * (rank - len(base))
    return (("layers",) + base) if in_stack else base


# -- embeddings & head --------------------------------------------------------------------------


def embed_tokens(model: Transformer, cfg: ModelConfig, batch: dict, compute_dtype):
    if active() is not None:
        return tensor_parallel.embed_tokens(model, cfg, batch, compute_dtype)
    emb = model.embed
    if cfg.modality == "audio":
        # batch["tokens"]: [B, K, S] -> sum of per-codebook embeddings
        codes = batch["tokens"].long()
        x = torch.zeros((codes.shape[0], codes.shape[2], cfg.d_model), dtype=compute_dtype,
                        device=emb.device)
        for kb in range(cfg.num_codebooks):
            x = x + emb[kb][codes[:, kb]].to(compute_dtype)
    else:
        x = emb[batch["tokens"].long()].to(compute_dtype)
        if cfg.modality == "vlm" and "image_embeds" in batch:
            # decode steps are text-only (the image is in the cache)
            x = torch.cat([batch["image_embeds"].to(compute_dtype), x], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype, device=x.device)
    return x


def _out_weight(model: Transformer, cfg: ModelConfig):
    if cfg.tie_embeddings:
        emb = model.embed
        return emb.T if cfg.modality != "audio" else emb.transpose(1, 2)
    return model.out


# -- full forward --------------------------------------------------------------------------------


def _superblock(model: Transformer, layer: int, x, positions, engine):
    """Layer ``layer`` of the stacked superblocks, in train mode; returns
    ``(x, aux)``."""
    cfg = model.cfg
    aux = 0.0
    x = constrain(x, _RESIDUAL)
    for i in range(len(cfg.superblock)):
        bdef, p = model.stack_block(layer, i)
        x, _, a = apply_block(bdef, p, x, cfg, positions, None, 0, "train", engine)
        aux += a
    return x, aux


def forward(model: Transformer, batch: dict, cache=None, cache_index: int = 0, mode: str = "train",
            engine: str = "auto"):
    """Modes:
    * train:   batch={tokens, ...} -> (x_final [B,S,d], None, aux)
    * prefill: like train, writing k/v into ``cache`` from ``cache_index`` on
      -> (x_final, cache, aux)
    * decode:  batch={tokens [B,1]}, cache, index -> (x_final [B,1,d], cache, aux)

    ``engine`` picks the attention, the SSD scan and the sLSTM scan of train
    and prefill (``layers.ENGINES``).
    The cache is updated in place and returned.  Train mode under grad (the
    parameters require it) builds an autograd graph; with ``cfg.remat`` other
    than ``"none"`` each stacked superblock is recomputed in the backward pass
    (``torch.utils.checkpoint``, the twin of the reference's
    ``jax.checkpoint`` around its scan body).  Both of the reference's remat
    policies recompute the whole superblock here: remat changes the memory,
    never the numbers.

    Under an active mesh (``sharding.activation_sharding``) the parameters,
    the batch and the cache are DTensors: the residual stream is anchored
    to ``("batch", "seq", None)`` after the embedding and at the top of each
    stacked superblock, and every block runs on local shards
    (``models/tensor_parallel.py``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode != "train" and cache is None:
        raise ValueError(f"mode {mode!r} needs a cache (init_cache)")
    cfg = model.cfg
    compute = _dt(cfg.compute_dtype)
    x = embed_tokens(model, cfg, batch, compute)
    x = constrain(x, _RESIDUAL)
    B, S = x.shape[:2]
    positions = None
    if mode != "decode":
        positions = (torch.arange(S, device=x.device) + cache_index).expand(B, S)
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    superblock = _superblock
    if remat and active() is not None:
        # the recomputation may run on the autograd engine's thread: carry the context there
        superblock = carry_context(_superblock)
    aux_total = 0.0
    for seg, pos, layer, bdef, p in model.blocks():
        if remat and seg == "stack":
            if pos == "0":  # one checkpoint per superblock, as the reference's scan body
                x, aux = checkpoint(superblock, model, layer, x, positions, engine,
                                    use_reentrant=False)
                aux_total += aux
            continue
        if seg == "stack" and pos == "0":
            x = constrain(x, _RESIDUAL)
        c = None
        if cache is not None:
            c = cache[seg][pos]
            if seg == "stack":
                c = {key: t[layer] for key, t in c.items()}
        x, _, aux = apply_block(bdef, p, x, cfg, positions, c, cache_index, mode, engine)
        aux_total += aux
    if active() is not None:
        x = tensor_parallel.rms_norm_rows(x, model.final_norm, cfg.norm_eps)
    else:
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, cache, aux_total


@torch.no_grad()
@full_float32_matmul()
def logits_from_hidden(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits of compute-dtype products, as the reference's
    ``preferred_element_type=float32`` einsum (bfloat16 products are exact
    in float32; the products run with TF32 off).  Under an active mesh a
    local product of the shards (``tensor_parallel.logits_from_hidden``),
    split over the model axis along the vocabulary."""
    cfg = model.cfg
    if active() is not None:
        return tensor_parallel.logits_from_hidden(model, cfg, x)
    w = _out_weight(model, cfg).to(x.dtype).float()
    if cfg.modality == "audio":
        logits = torch.einsum("bsd,kdv->bksv", x.float(), w)
    else:
        logits = x.float() @ w
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def loss_fn(model: Transformer, batch: dict, *, engine: str = "auto"):
    """Mean-token cross-entropy (+ ``moe_aux_coef`` x the aux loss) without
    materializing full logits; returns ``(loss, {"ce": ce, "aux": aux})``.
    ``batch["labels"]`` is [B, S] ([B, K, S] for audio, one loss per codebook,
    averaged); a VLM takes no loss on its ``img_tokens`` image positions.
    ``engine`` picks the attention, the SSD scan and the cross-entropy
    (``layers.ENGINES``)."""
    cfg = model.cfg
    x, _, aux = forward(model, batch, mode="train", engine=engine)
    w = _out_weight(model, cfg)
    labels = batch["labels"]
    kw = dict(chunk=cfg.ce_chunk, final_softcap=cfg.final_softcap, engine=engine)
    if cfg.modality == "audio":
        ce = sum(cross_entropy_chunked(x, w[kb], labels[:, kb], **kw)
                 for kb in range(cfg.num_codebooks)) / cfg.num_codebooks
    else:
        mask = None
        if cfg.modality == "vlm":
            B, S = labels.shape
            mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
            mask[:, :cfg.img_tokens] = 0.0
        ce = cross_entropy_chunked(x, w, labels, mask=mask, **kw)
    return ce + cfg.moe_aux_coef * aux, {"ce": ce, "aux": aux}


"""Serving engine: prefill + decode step functions and a batched generation
loop over fixed slots.

``make_prefill_step`` / ``make_decode_step`` build the two steps;
``Engine`` drives them for real generation (``launch/serve.py`` and the
tests).  Everything runs eagerly and the KV cache is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels import ops
from ..models import ModelConfig, Transformer, forward, init_cache, logits_from_hidden
from ..models.attention import ATTN_ENGINES
from ..models.sharding import active

__all__ = ["make_prefill_step", "make_decode_step", "Engine", "Request", "sample_token"]

#: matrices the reference reads in float32 at every use, which the Engine
#: leaves float32: an sLSTM block's recurrent weights, a MoE router
_FLOAT32_MATRICES = ("r_zifo", "moe.router")


def make_prefill_step(cfg: ModelConfig, engine: str = "auto") -> Callable:
    """(model, batch, cache) -> (last_logits, cache).  The tokens' length
    fills cache[0:S]; ``engine`` picks the attention, the SSD scan and the
    sLSTM scan (``"cuda"`` kernels, ``"torch"`` plain versions, ``"auto"`` by device).  Runs under
    ``torch.inference_mode``: serving builds no autograd graph (under an
    active mesh ``torch.no_grad``: the DTensor cache's views need version
    counters)."""

    def prefill(model, batch, cache):
        with _no_graph():
            x, cache, _ = forward(model, batch, cache=cache, cache_index=0, mode="prefill",
                                  engine=engine)
            return logits_from_hidden(model, x[:, -1:]), cache

    return prefill


def _no_graph():
    return torch.no_grad() if active() is not None else torch.inference_mode()


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(model, tokens [B,1] (or [B,K,1] audio), cache, index) -> (logits, cache)."""

    def decode(model, tokens, cache, index):
        with _no_graph():
            x, cache, _ = forward(model, {"tokens": tokens}, cache=cache, cache_index=index,
                                  mode="decode")
            return logits_from_hidden(model, x), cache

    return decode


def sample_token(generator: torch.Generator, logits: torch.Tensor, temperature: float = 0.0,
                 top_k: int = 0) -> torch.Tensor:
    """logits: [B, 1, V] (or [B, K, 1, V] audio) -> int32 token ids.  Greedy
    (the first maximum) at ``temperature <= 0``; else a draw from
    ``generator`` over ``softmax(logits / temperature)``, with logits below
    the ``top_k``-th largest set to -1e30."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, torch.full((), -1e30, device=logits.device), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    draws = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return draws.reshape(probs.shape[:-1]).to(torch.int32)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # [S] token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Fixed-slot batched generation: up to ``slots`` sequences share one
    prefill and one decode step per token.

    ``device=None`` means the card; without one the engine raises unless the
    caller passes ``device="cpu"``.  ``engine`` picks the prefill's kernels
    (flash attention, the SSD scan, the sLSTM scan): ``"cuda"`` the kernels (CUDA only),
    ``"torch"`` their plain PyTorch versions on any device, ``"auto"`` the
    kernels on a CUDA device and the plain versions on the CPU.  The model
    is moved to the device and its matrices (parameters of two or more
    dimensions, a mamba2 block's ``conv_w`` and an mLSTM block's ``wq``,
    ``wk`` and ``w_if`` among them) are cast to the compute dtype in place,
    once: the reference casts them to the compute dtype at every use, to the
    same numbers.  An sLSTM block's recurrent weights ``r_zifo`` and a MoE
    FFN's ``router`` stay float32, because the reference reads them in
    float32 at every step; so do norm scales (an MLA block's ``kv_norm``
    among them), biases and a mamba2 block's ``A_log``, ``D`` and
    ``dt_bias``.  So a model that is still being trained must not be handed
    to an ``Engine``: serve a copy, or a checkpoint restored into a new
    model."""

    def __init__(self, cfg: ModelConfig, model: Transformer, capacity: int = 256, slots: int = 4,
                 temperature: float = 0.0, seed: int = 0, device=None, engine: str = "auto"):
        if engine not in ATTN_ENGINES:
            raise ValueError(f"engine must be one of {ATTN_ENGINES}, got {engine!r}")
        self.device = ops.resolve_device(engine, device)
        self.cfg = cfg
        self.capacity = capacity
        self.slots = slots
        self.temperature = temperature
        self.engine = engine
        compute = getattr(torch, cfg.compute_dtype)
        self.model = model.to(self.device)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if p.dim() >= 2 and p.dtype != compute and not name.endswith(_FLOAT32_MATRICES):
                    p.data = p.data.to(compute)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = make_prefill_step(cfg, engine)
        self._decode = make_decode_step(cfg)

    def generate(self, prompts: "list[np.ndarray]", max_new: int = 16) -> "list[list[int]]":
        """Groups the prompts into batches of ``slots``.  Prompts in one group
        are left-padded with token 0 to equal length; the pads take part in
        attention (positions stay causal), as in the reference."""
        out: list[list[int]] = []
        for i in range(0, len(prompts), self.slots):
            out.extend(self._generate_group(prompts[i:i + self.slots], max_new))
        return out

    def _generate_group(self, group, max_new: int):
        B = len(group)
        S = max(len(p) for p in group)
        if S + max_new - 1 > self.capacity:
            raise ValueError(f"{S} prompt + {max_new} new tokens overflow capacity {self.capacity}")
        toks = np.zeros((B, S), np.int64)
        for j, p in enumerate(group):
            toks[j, S - len(p):] = p  # left-pad (positions still causal)
        cache = init_cache(self.cfg, B, self.capacity, device=self.device)
        tokens = torch.from_numpy(toks).to(self.device)
        logits, cache = self._prefill(self.model, {"tokens": tokens}, cache)
        outs: list[list[int]] = [[] for _ in group]
        index = S
        for step in range(max_new):
            tok = sample_token(self.generator, logits, self.temperature)
            for j, t in enumerate(tok[:, 0].tolist()):
                outs[j].append(t)
            if step + 1 < max_new:
                logits, cache = self._decode(self.model, tok[:, :1], cache, index)
                index += 1
        return outs

"""Deterministic synthetic data pipeline (+ a memmap token-file reader).

Synthetic streams are *stateless*: batch at step ``s`` is a pure function of
(seed, s), so resuming from a checkpoint just means ``skip_to(step)`` — no
iterator state to persist.  The token hash is pure numpy and the same as the
reference package's, so both packages see the same batches; the batches are
tensors on ``device`` (the host by default).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import ModelConfig

__all__ = ["SyntheticLM", "MemmapTokens", "make_data"]


def _tokens_for_step(seed: int, step: int, shape, vocab: int) -> np.ndarray:
    """Cheap counter-based PRNG (philox-like mix) — identical on every host."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64) + np.uint64(step) * np.uint64(n)
    x = idx * np.uint64(6364136223846793005) + np.uint64(seed * 2 + 1)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x % np.uint64(vocab)).astype(np.int32).reshape(shape)


def _on(device, **arrays) -> dict:
    return {key: torch.from_numpy(np.ascontiguousarray(a)).to(device) for key, a in arrays.items()}


@dataclasses.dataclass
class SyntheticLM:
    """Markov-flavored synthetic LM batches: tokens are hash noise, labels are
    next-token shifts, so CE starts at ~ln(V) and a real model can still fit
    local correlations (we inject short-range structure for learnability)."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    structured: bool = True
    device: str = "cpu"
    _step: int = 0

    def skip_to(self, step: int) -> None:
        self._step = step

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        if cfg.modality == "audio":
            shape = (self.batch, cfg.num_codebooks, self.seq + 1)
        elif cfg.modality == "vlm":
            shape = (self.batch, self.seq - cfg.img_tokens + 1)
        else:
            shape = (self.batch, self.seq + 1)
        toks = _tokens_for_step(self.seed, step, shape, self.cfg.vocab)
        if self.structured:
            # short-range structure: every odd position repeats its neighbor
            # (mod vocab) so models that attend locally beat the entropy floor
            if cfg.modality == "audio":
                toks[:, :, 1::2] = (toks[:, :, 0::2][:, :, : toks[:, :, 1::2].shape[2]] + 1) % cfg.vocab
            else:
                toks[:, 1::2] = (toks[:, 0::2][:, : toks[:, 1::2].shape[1]] + 1) % cfg.vocab
        if cfg.modality == "audio":
            return _on(self.device, tokens=toks[:, :, :-1], labels=toks[:, :, 1:])
        if cfg.modality == "vlm":
            rng = np.random.RandomState((self.seed, step, 7) .__hash__() % (2**31))
            img = rng.randn(self.batch, cfg.img_tokens, cfg.d_model).astype(np.float32) * 0.02
            labels = np.concatenate(
                [np.zeros((self.batch, cfg.img_tokens), np.int32), toks[:, 1:]], axis=1
            )
            return _on(self.device, tokens=toks[:, :-1], image_embeds=img, labels=labels)
        return _on(self.device, tokens=toks[:, :-1], labels=toks[:, 1:])

    def next_batch(self) -> dict:
        b = self.batch_at(self._step)
        self._step += 1
        return b


@dataclasses.dataclass
class MemmapTokens:
    """Packed int32 token file (pre-tokenized shards).  Sequential chunking
    with a deterministic per-step offset."""

    path: str
    cfg: ModelConfig
    batch: int
    seq: int
    device: str = "cpu"
    _step: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._per_step = self.batch * (self.seq + 1)
        if len(self._data) < self._per_step:
            raise ValueError("token file smaller than one batch")

    def skip_to(self, step: int) -> None:
        self._step = step

    def next_batch(self) -> dict:
        n_steps = len(self._data) // self._per_step
        ofs = (self._step % n_steps) * self._per_step
        chunk = np.array(self._data[ofs : ofs + self._per_step]).reshape(
            self.batch, self.seq + 1
        )
        self._step += 1
        return _on(self.device, tokens=chunk[:, :-1], labels=chunk[:, 1:])


def make_data(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, path: str | None = None,
              device: str = "cpu"):
    if path:
        return MemmapTokens(path, cfg, batch, seq, device=device)
    return SyntheticLM(cfg, batch, seq, seed, device=device)

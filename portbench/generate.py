"""The one generator of the benchmark's inputs: weights and traffic, made
from ``--seed`` and the data files under ``configs/`` and ``traffic/``.

* Weights: every parameter of a reference's table is ``mean + std * z``,
  ``z`` standard normal, drawn on the device by one ``torch.Generator`` in
  a few large calls (``DRAW`` elements each) in the table's order, so that
  the same seed gives the same weights to the program and to the reference.
* ``kind: train``: a fresh batch of ``batch x (seq_len + 1)`` tokens a step,
  uniform over the vocabulary, from the seed and the step's number; the
  labels are the tokens shifted by one.
* ``kind: serve``: passes of a cycle of ``groups_per_cycle`` groups of
  ``slots`` prompts.  Every pass of every seed has the same prompt
  lengths, the quantiles of a log-uniform law over ``[prompt_min,
  prompt_max]``, dealt into the same groups in the same order (by
  ``partition_seed``), so that a window that ends inside a pass does the
  same work for every seed; the seed and the pass's number order the
  prompts in each group and draw fresh tokens, so that no prompt comes
  twice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["DRAW", "weight_pieces", "fill_weights", "reference_weights", "sub_seed", "train_batch",
           "serve_pass"]

#: elements of one normal draw (512 MiB of float32)
DRAW = 1 << 27


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` and labels."""
    h = seed & ((1 << 64) - 1)
    for p in parts:
        h = (h * 0x9E3779B97F4A7C15 + p + 1) & ((1 << 64) - 1)
        h ^= h >> 29
    return h & ((1 << 63) - 1)


def weight_pieces(table: list, seed: int, device):
    """Yields ``(name, offset, values)``: consecutive pieces of each
    parameter's flattened float32 values, in the table's order."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    total = sum(math.prod(shape) for _, shape, _, _ in table)
    leaf, offset = 0, 0
    drawn = 0
    while drawn < total:
        n = min(DRAW, total - drawn)
        z = torch.randn(n, generator=gen, device=device)
        pos = 0
        while pos < n:
            name, shape, mean, std = table[leaf]
            size = math.prod(shape)
            take = min(size - offset, n - pos)
            yield name, offset, z[pos:pos + take].mul(std).add_(mean)
            pos += take
            offset += take
            if offset == size:
                leaf, offset = leaf + 1, 0
        drawn += n
        del z


@torch.no_grad()
def fill_weights(targets: dict, table: list, seed: int, device) -> None:
    """Writes every parameter of ``table`` into ``targets`` (name -> a
    contiguous tensor of the table's shape, in any float dtype)."""
    for name, offset, values in weight_pieces(table, seed, device):
        flat = targets[name].view(-1)
        flat[offset:offset + values.numel()].copy_(values)


def reference_weights(table: list, seed: int, device) -> dict:
    """``{name: float32 tensor}`` of every parameter of ``table``."""
    params = {name: torch.empty(shape, device=device) for name, shape, _, _ in table}
    fill_weights(params, table, seed, device)
    return params


def train_batch(traffic: dict, vocab: int, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: ``{"tokens", "labels"}``, int64 ``[B, S]``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, step))
    B, S = traffic["batch"], traffic["seq_len"]
    t = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def prompt_lengths(traffic: dict) -> list:
    """The cycle's prompt lengths: log-uniform quantiles, the same for every seed."""
    n = traffic["slots"] * traffic["groups_per_cycle"]
    lo, hi = math.log(traffic["prompt_min"]), math.log(traffic["prompt_max"])
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo)))) for i in range(n)]


def serve_pass(traffic: dict, vocab: int, seed: int, number: int) -> list:
    """Pass ``number`` of the cycle: ``[group, ...]``, each a list of
    ``slots`` int64 prompt arrays; the tokens are in ``[1, vocab)`` (0 is
    the engine's pad)."""
    lengths = prompt_lengths(traffic)
    deal = np.random.RandomState(traffic["partition_seed"]).permutation(len(lengths))
    slots = traffic["slots"]
    groups = [[lengths[j] for j in deal[g * slots:(g + 1) * slots]]
              for g in range(traffic["groups_per_cycle"])]
    rng = np.random.default_rng(sub_seed(seed, 3, number))
    out = []
    for group in groups:
        sizes = [group[j] for j in rng.permutation(slots)]
        out.append([rng.integers(1, vocab, size=n, dtype=np.int64) for n in sizes])
    return out

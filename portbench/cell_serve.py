"""The driver of ``kind: serve`` traffic: a closed loop of request groups
through the program's ``Engine.generate``, greedy.

Set-up draws the weights from the seed on the device in the types the
engine serves them in (matrices in the compute dtype, the MoE router and
the vectors float32), builds the ``Engine`` and warms it on the longest and
shortest groups of pass 0 of the cycle.  The window hands one group of
``slots`` requests to ``Engine.generate`` at a time, through passes 1, 2,
... of the cycle (the same groups of lengths, fresh tokens each pass),
until ``--seconds`` have passed; each request's latency is its group's
call.  ``serve_tokens_per_s`` counts every request's prompt tokens
(pads not counted) and generated tokens.  After the window the plain
reference reads a sample of the finished groups, the longest among them,
in float32: each group's padded prompts and served tokens, the prompt
and each decode step routed as the forward calls they were served in.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from .generate import fill_weights, reference_weights, serve_pass, sub_seed
from .reference.common import full_float32, init_table_fill
from .trace import traced

__all__ = ["run", "served_model", "token_gaps", "gap_numbers", "FLOAT32_MATRICES"]

#: matrices served in float32 (the engine's rule): a MoE router
FLOAT32_MATRICES = ("moe.router",)


def served_model(cfg, table: list, seed: int, device):
    """The program's model with the seed's weights, each parameter made in
    the type it is served in."""
    from repro_torch.models import Transformer

    compute = getattr(torch, cfg.compute_dtype)
    model = Transformer(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        dtype = compute if p.dim() >= 2 and not name.endswith(FLOAT32_MATRICES) else torch.float32
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, torch.nn.Parameter(torch.empty(p.shape, dtype=dtype, device=device),
                                                 requires_grad=False))
    named = dict(model.named_parameters())
    init_table_fill(table, named)
    fill_weights({n: p.data for n, p in named.items()}, table, seed, device)
    return model


def _padded(group: list, served: list, max_new: int, device) -> tuple[torch.Tensor, int]:
    """The group's rows as served: prompts left-padded with 0 to the
    longest, then the served tokens but the last; and the prompt length."""
    S = max(len(p) for p in group)
    rows = np.zeros((len(group), S + max_new - 1), np.int64)
    for j, (p, out) in enumerate(zip(group, served)):
        rows[j, S - len(p):S] = p
        rows[j, S:] = out[:max_new - 1]
    return torch.from_numpy(rows).to(device), S


@torch.no_grad()
def token_gaps(family, params: dict, config: dict, group: list, served: list, max_new: int,
               device, prec=None) -> tuple[list, "list | None"]:
    """``(the gap of each served token below the reference's best logit at
    its position, the same of the tokens that ``prec``'s logits put
    first)``: the reference in float32 reads the served tokens; with
    ``prec`` set, the reference computed in that precision picks its own
    first tokens at the same positions, read under the float32 logits
    (None without ``prec``)."""
    rows, S = _padded(group, served, max_new, device)
    calls = [(0, S)] + [(S + j, S + j + 1) for j in range(max_new - 1)]
    with full_float32():
        h, _ = family.hidden(params, rows, config, None, calls=calls)
        logits = h[:, S - 1:S - 1 + max_new] @ family.head(params)
        best = logits.max(-1).values
        tok = torch.tensor([list(o) for o in served], device=device)
        gaps = (best - logits.gather(-1, tok[..., None])[..., 0]).flatten().tolist()
        if prec is None:
            return gaps, None
        h, _ = family.hidden(params, rows, config, prec, calls=calls)
        low = (h[:, S - 1:S - 1 + max_new] @ family.head(params)).argmax(-1)
        low_gaps = (best - logits.gather(-1, low[..., None])[..., 0]).flatten().tolist()
    return gaps, low_gaps


def gap_numbers(gaps: list) -> dict:
    """The compared numbers of the sampled served tokens' gaps: the widest
    (``token_gap``) and the mean (``token_gap_mean``)."""
    return {"token_gap": max(gaps), "token_gap_mean": statistics.fmean(gaps)}


def _sample(done: list, prompts, k: int, seed: int) -> list:
    """``k`` finished groups drawn from the seed, the longest among them;
    ``prompts(key)`` is a group's prompts."""
    longest = max(done, key=lambda g: max(len(p) for p in prompts(g)))
    others = [g for g in done if g != longest]
    rng = np.random.default_rng(sub_seed(seed, 4))
    pick = rng.choice(len(others), size=min(k - 1, len(others)), replace=False)
    return [longest] + [others[i] for i in sorted(pick)]


def run(cell, cfg, seed: int, seconds: float, trace: bool, device: str, started: float) -> dict:
    from repro_torch.serve import Engine

    from .harness import reference_family

    c, traffic = cell.config, cell.traffic
    family = reference_family(c)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    max_new, V = traffic["max_new"], c["vocab_size"]
    model = served_model(cfg, family.param_table(c), seed, device)
    engine = Engine(cfg, model, capacity=traffic["capacity"], slots=traffic["slots"],
                    device=device)
    passes = {}

    def prompts(key: tuple) -> list:
        """The prompts of group ``key = (pass, group)``."""
        number, g = key
        if number not in passes:
            passes[number] = serve_pass(traffic, V, seed, number)
        return passes[number][g]

    n_groups = traffic["groups_per_cycle"]
    by_length = sorted(range(n_groups), key=lambda g: max(len(p) for p in prompts((0, g))))
    for g in (by_length[-1], by_length[0]):
        engine.generate(prompts((0, g)), max_new)
    if on_card:
        torch.cuda.synchronize()

    marks: list = []
    if trace:  # the decode steps' span: CUDA events around the engine's calls into its decode step
        decode = engine._decode

        def timed_decode(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = decode(*args)
            end.record()
            marks.append((start, end))
            return out

        engine._decode = timed_decode

    tr, results = {}, []
    setup_s = time.time() - started
    with traced(trace, tr):
        t0 = time.perf_counter()
        i = 0
        while True:
            number, g = divmod(i, n_groups)
            key = (number + 1, g)
            group = prompts(key)
            ts = time.perf_counter()
            outs = engine.generate(group, max_new)
            te = time.perf_counter()
            results.append((key, outs, te - ts))
            i += 1
            if te - t0 >= seconds:
                break
        elapsed = te - t0
    latencies, prompt_lengths, tokens, failed = [], [], 0, 0
    for key, outs, dt in results:
        for p, out in zip(prompts(key), outs):
            latencies.append(dt)
            prompt_lengths.append(len(p))
            tokens += len(p) + len(out)
            failed += len(out) != max_new
    p95 = statistics.quantiles(latencies, n=20, method="inclusive")[-1]
    print(f"latency_p95_ms over {len(latencies)} requests in {len(results)} groups",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    served = {key: outs for key, outs, _ in results}
    spans = [start.elapsed_time(end) / 1e3 for start, end in marks]
    if trace and not spans:
        raise RuntimeError("the traced window called no decode step through Engine._decode")
    del engine, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check_t0 = time.perf_counter()
    params = reference_weights(family.param_table(c), seed, device)
    gaps, detail = [], []
    for key in _sample(sorted(served), prompts, traffic["check_groups"], seed):
        group_gaps = token_gaps(family, params, c, prompts(key), served[key], max_new, device)[0]
        gaps += group_gaps
        detail.append(f"pass {key[0]} group {key[1]}: prompts up to "
                      f"{max(len(p) for p in prompts(key))} tokens, widest "
                      f"gap {max(group_gaps)!r}, mean {statistics.fmean(group_gaps)!r}")
    del params
    ctx = {"kind": "serve", "window_s": elapsed, "busy_s": tr.get("busy_s"),
           "kernels": tr.get("kernels", []), "spans": {"decode": spans},
           "prompt_lengths": prompt_lengths}
    return {
        "end_to_end": {"serve_tokens_per_s": tokens / elapsed, "latency_p95_ms": 1e3 * p95,
                       "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        "ctx": ctx, "breakdown": tr.get("breakdown"),
        "checks": gap_numbers(gaps), "detail": detail, "answered": failed == 0,
        "check_s": time.perf_counter() - check_t0,
        "attempted": len(latencies), "failed": failed, "memory_peak_bytes": peak,
        "device_kind": kind,
    }

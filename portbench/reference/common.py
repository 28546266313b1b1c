"""Plain float32 building blocks shared by the model references.

Nothing here imports the system under test: every function is written from
the published descriptions in plain ``torch`` operations, with TF32 off
(:func:`full_float32`).  ``prec`` selects the precision of every product's
operands: ``None`` keeps float32, ``"fp8"`` rounds both operands of each
product to float8 e4m3 with a per-tensor scale (amax to 448) and passes the
gradient straight through.  The fp8 form is the control of the benchmark's
correctness check: the step below the bfloat16 the configurations compute in.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["full_float32", "round_operand", "mm", "einsum", "rms_norm", "rope", "swiglu",
           "cross_entropy_sum", "warmup_cosine", "adamw_update", "init_table_fill"]

FP8_MAX = 448.0


@contextlib.contextmanager
def full_float32():
    """Float32 products in full precision inside the block (TF32 off), the
    caller's settings put back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_operand(x: torch.Tensor, prec) -> torch.Tensor:
    """``x`` as a product reads it at precision ``prec`` (float32 values)."""
    if prec is None:
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    with torch.no_grad():
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, prec=None) -> torch.Tensor:
    return round_operand(a, prec) @ round_operand(b, prec)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, prec=None) -> torch.Tensor:
    return torch.einsum(eq, round_operand(a, prec), round_operand(b, prec))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with a ``(1 + scale)`` gain."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [B, S, H, D]`` at ``positions [S]``: the
    head's two halves rotated as pairs ``(x_i, x_{i + D/2})``, frequency
    ``theta ** (-i / (D/2))``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs  # [S, half]
    sin, cos = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, w1, w3, w2, prec=None) -> torch.Tensor:
    return mm(F.silu(mm(x, w1, prec)) * mm(x, w3, prec), w2, prec)


def _ce_rows(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, prec) -> torch.Tensor:
    logits = mm(h, w, prec)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(1, labels[:, None].long())[:, 0]).sum()


def cross_entropy_sum(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, prec=None,
                      rows: int = 2048) -> torch.Tensor:
    """Summed token cross-entropy of ``h [T, d] @ w [d, V]`` against
    ``labels [T]``, in blocks of ``rows`` rows, each recomputed in the
    backward pass so that no ``[T, V]`` logits are held."""
    total = h.new_zeros(())
    for lo in range(0, h.shape[0], rows):
        args = (h[lo:lo + rows], w, labels[lo:lo + rows], prec)
        if torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(_ce_rows, *args, use_reentrant=False)
        else:
            total = total + _ce_rows(*args)
    return total


def warmup_cosine(step: int, peak: float, warmup: int, total: int, floor: float = 0.1) -> float:
    """Linear warm-up to ``peak`` (step ``s`` of the warm-up at ``(s + 1) /
    warmup``), then a cosine decay to ``floor * peak`` at ``total``."""
    if step < warmup:
        return peak * min(1.0, (step + 1.0) / max(warmup, 1))
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, step: int, opt: dict) -> float:
    """One AdamW step in place (Loshchilov & Hutter): the gradients clipped
    to global norm ``opt["clip_norm"]``, bias-corrected moments, decoupled
    weight decay.  Returns the global norm before clipping."""
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())).item()
    scale = min(1.0, opt["clip_norm"] / max(norm, 1e-9))
    lr = warmup_cosine(step, opt["lr"], opt["warmup_steps"], opt["total_steps"])
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    for name, p in params.items():
        g = grads[name] * scale
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * ((m / c1) / ((v / c2).sqrt() + eps) + wd * p))
    return norm


def init_table_fill(table: list, values: dict) -> None:
    """Checks ``values`` (name -> tensor) against ``table``'s names and shapes."""
    want = {name: tuple(shape) for name, shape, _, _ in table}
    got = {name: tuple(t.shape) for name, t in values.items()}
    if want != got:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])[:5]
        raise ValueError(f"parameters differ from the reference's table: missing {missing}, "
                         f"extra {extra}, shapes {wrong}")

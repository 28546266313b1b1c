"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes on whatever device its tensors live on.  The kernel
wrappers take these for CPU tensors, and ``chip_smoke.py`` holds every
kernel against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["parzen_score_ref", "mc_hv_counts_ref"]

#: elements of the boolean (samples, points, objectives) cube per chunk
_MC_CUBE_ELEMS = 1 << 27


def parzen_score_ref(
    cands: torch.Tensor,  # [C]
    l_mus: torch.Tensor, l_sigmas: torch.Tensor, l_log_norm: torch.Tensor,  # [Kl]
    g_mus: torch.Tensor, g_sigmas: torch.Tensor, g_log_norm: torch.Tensor,  # [Kg]
) -> torch.Tensor:
    """TPE acquisition ``log l - log g`` as a [C] float32 tensor: the
    ``(C, K)`` exponent matrix of each side is materialized, clamped at
    ``-1e30`` (so ``-inf``-padded components stay inert) and reduced with
    ``torch.logsumexp`` (oracle for the fused online-accumulation kernel)."""
    cands = cands.to(torch.float32)

    def side(mus, sigmas, ln):
        mus, sigmas, ln = (t.to(torch.float32) for t in (mus, sigmas, ln))
        z = (cands[:, None] - mus[None, :]) / sigmas[None, :]
        e = torch.clamp(-0.5 * z * z + ln[None, :], min=-1e30)
        return torch.logsumexp(e, dim=1)

    return side(l_mus, l_sigmas, l_log_norm) - side(g_mus, g_sigmas, g_log_norm)


def mc_hv_counts_ref(
    points: torch.Tensor,  # [n, m]
    samples: torch.Tensor,  # [s, m]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo hypervolume counts ``(excl [n] float32, total float32
    0-d)`` on the inputs' device: the broadcast ``(s, n, m)`` domination cube
    ``points <= samples`` reduced over objectives, then the dominators per
    sample, the samples with any dominator (``total``) and, per point, the
    samples it alone dominates (``excl``).  Samples go in chunks so the cube
    stays near ``_MC_CUBE_ELEMS`` booleans (oracle for the streaming
    kernel)."""
    points = points.to(torch.float32)
    samples = samples.to(torch.float32)
    n, m = points.shape
    excl = torch.zeros(n, dtype=torch.int64, device=points.device)
    total = torch.zeros((), dtype=torch.int64, device=points.device)
    chunk = max(1, _MC_CUBE_ELEMS // max(1, n * m))
    for start in range(0, len(samples), chunk):
        smp = samples[start:start + chunk]
        dom = (points[None, :, :] <= smp[:, None, :]).all(dim=2)  # [c, n]
        cnt = dom.sum(dim=1)
        total += (cnt > 0).sum()
        excl += (dom & (cnt == 1)[:, None]).sum(dim=0)
    return excl.to(torch.float32), total.to(torch.float32)

"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes on whatever device its tensors live on.  The kernel
wrappers take these for CPU tensors, and ``chip_smoke.py`` holds every
kernel against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["parzen_score_ref"]


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

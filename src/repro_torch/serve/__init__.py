from __future__ import annotations

from .engine import Engine, Request, make_decode_step, make_prefill_step, sample_token

__all__ = ["Engine", "Request", "make_prefill_step", "make_decode_step", "sample_token"]

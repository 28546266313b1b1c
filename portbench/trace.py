"""The traced window: ``torch.profiler`` (CPU and CUDA activities) over the
measured window of a ``--trace 1`` run, reduced to what the per-layer
metrics read.

* ``kernels``: ``(name, start_s, seconds)`` of every device activity
  (kernels, copies, sets) in the window;
* ``busy_s``: the union of their intervals, so overlapping work counts once;
* ``breakdown``: the device operations that took most time, and the
  longest idle gaps by what the host was doing (the innermost host event
  that covers the gap's middle), at most 10 of each.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

__all__ = ["traced"]

TOP = 10
#: idle gaps shorter than this are not attributed (the launch cadence)
MIN_GAP_S = 20e-6
#: the longest gaps attributed to a host event
ATTRIBUTED = 2000


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profiles the block when ``enabled`` and fills ``out`` with
    ``kernels``, ``busy_s`` and ``breakdown`` after it (nothing otherwise)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    out.update(reduce_events(prof.profiler.kineto_results.events()))


def _union(intervals: list) -> tuple[float, list]:
    """``(covered seconds, [(gap_start, gap_end)])`` of sorted intervals."""
    busy, gaps = 0.0, []
    end = None
    for s, e in intervals:
        if end is None:
            busy += e - s
            end = e
        elif s > end:
            gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def reduce_events(events) -> dict:
    device, host = [], []
    for ev in events:
        start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((ev.name(), start, dur))
        elif dur > 0:
            host.append((start, start + dur, ev.name()))
    device.sort(key=lambda k: k[1])
    busy, gaps = _union([(s, s + d) for _, s, d in device])
    by_op = defaultdict(float)
    for name, _, dur in device:
        by_op[name.split("(")[0][:120]] += dur
    host.sort()
    starts = [h[0] for h in host]
    by_host = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:ATTRIBUTED]:
        if g1 - g0 < MIN_GAP_S:
            break
        mid = 0.5 * (g0 + g1)
        best = None
        hi = bisect.bisect_right(starts, mid)
        for s, e, name in host[max(0, hi - 2000):hi]:
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        by_host[best[2][:120] if best else "(no host event)"] += g1 - g0
    return {"kernels": device, "busy_s": busy,
            "breakdown": {"device_ops": _top(by_op), "idle_gaps": _top(by_host)}}


def _top(seconds: dict) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]

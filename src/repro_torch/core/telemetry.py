"""Zero-dependency telemetry: metrics registry, timing spans, trial event trace.

Two pillars:

* A **metrics registry** — counters, gauges, and fixed-bucket latency
  histograms with interpolated p50/p95/p99 — all thread-safe and near-zero
  cost when disabled.  The module-level helpers (:func:`inc`, :func:`span`,
  :func:`observe`, ...) route through one global registry that is **off by
  default**: a disabled ``span()`` returns a shared no-op context manager and
  a disabled ``inc()`` is a single attribute check, so instrumented hot paths
  (``Study.ask``, the fused ``report_and_prune``, ``TPESampler`` scoring)
  cost next to nothing while it is off.

* A **trial-lifecycle event trace** — :class:`TrialEventLog` records
  created/claimed/reported/pruned/completed/failed events columnarly
  (int8 kinds, int64 numbers/steps/monotonic-ns timestamps, interned worker
  ids) so a study's full trace costs a few flat arrays and reads back as
  plain JSON columns (``BaseStorage.get_trial_events``).

Metric names are dotted lowercase ``component.operation[.detail]`` —
e.g. ``study.ask`` and ``tpe.score`` (histograms, seconds),
``records.obs.refresh.noop`` (counter).  The span names match the reference
package's, so both packages' traces read alike.  Latency histograms are
always in **seconds**.
"""

from __future__ import annotations

import bisect
import math
import os
import socket
import threading
import time
from typing import Any, Iterator

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TrialEventLog",
    "EVENT_KINDS",
    "EV_CREATED",
    "EV_CLAIMED",
    "EV_REPORTED",
    "EV_PRUNED",
    "EV_COMPLETED",
    "EV_FAILED",
    "enable",
    "disable",
    "enabled",
    "counter",
    "gauge",
    "histogram",
    "inc",
    "set_gauge",
    "observe",
    "span",
    "snapshot",
    "reset",
    "worker_id",
    "set_worker_context",
]


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic int counter; ``inc`` is lock-guarded (int += is not atomic)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar (active connections, queue depths, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        return self._value


# Fixed geometric bucket grid shared by every histogram: 10 buckets/decade
# from 100ns to 100s.  Latencies are recorded in seconds; anything above the
# top bound lands in the overflow bucket and percentiles clamp to max_seen.
_BOUNDS: list[float] = [
    float(b) for b in np.geomspace(1e-7, 100.0, num=91)
]


class Histogram:
    """Fixed-bucket latency histogram with interpolated percentiles.

    Shared geometric bucket bounds (1e-7s .. 100s, 10/decade) keep recording
    O(log n_buckets) via bisect and make snapshots mergeable; percentile
    queries interpolate within the winning bucket, clamped to the observed
    min/max so p99 of a tight distribution doesn't smear to bucket edges.
    """

    __slots__ = ("name", "_counts", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * (len(_BOUNDS) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        idx = bisect.bisect_left(_BOUNDS, seconds)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += seconds
            if seconds < self._min:
                self._min = seconds
            if seconds > self._max:
                self._max = seconds

    def percentile(self, q: float) -> float:
        """Interpolated quantile, ``q`` in [0, 1]."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = q * total
            cum = 0
            for idx, c in enumerate(self._counts):
                cum += c
                if cum >= rank and c > 0:
                    lo = _BOUNDS[idx - 1] if idx > 0 else 0.0
                    hi = _BOUNDS[idx] if idx < len(_BOUNDS) else self._max
                    frac = (rank - (cum - c)) / c
                    est = lo + (hi - lo) * frac
                    return float(min(max(est, self._min), self._max))
            return float(self._max)

    def summary(self) -> dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "min": self._min if count else 0.0,
            "max": self._max,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-span fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._hist.observe(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Thread-safe name -> instrument map with a machine-readable snapshot."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- instrument accessors (create on first use) --
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    # -- recording helpers honoring the enabled flag --
    def inc(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        if self.enabled:
            self.gauge(name).set(v)

    def observe(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.histogram(name).observe(seconds)

    def span(self, name: str) -> Any:
        if not self.enabled:
            return _NOOP
        return _Span(self.histogram(name))

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe dump: counters/gauges as scalars, histograms summarized."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary() for k, h in sorted(hists.items())},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# global registry (off by default; spans collapse to _NOOP while disabled)
# ---------------------------------------------------------------------------

_registry = MetricsRegistry(enabled=False)


def enable() -> None:
    _registry.enabled = True


def disable() -> None:
    _registry.enabled = False


def enabled() -> bool:
    return _registry.enabled


def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


def inc(name: str, n: int = 1) -> None:
    if _registry.enabled:
        _registry.counter(name).inc(n)


def set_gauge(name: str, v: float) -> None:
    if _registry.enabled:
        _registry.gauge(name).set(v)


def observe(name: str, seconds: float) -> None:
    if _registry.enabled:
        _registry.histogram(name).observe(seconds)


def span(name: str) -> Any:
    if not _registry.enabled:
        return _NOOP
    return _Span(_registry.histogram(name))


def snapshot() -> dict[str, Any]:
    return _registry.snapshot()


def reset() -> None:
    _registry.reset()


# ---------------------------------------------------------------------------
# worker identity
# ---------------------------------------------------------------------------

_HOST = socket.gethostname()
_tls = threading.local()


def set_worker_context(ident: str | None) -> None:
    """Override this thread's worker id (server handlers set the client's
    peer address so server-recorded events carry *client* identity)."""
    _tls.worker = ident


def worker_id() -> str:
    ident = getattr(_tls, "worker", None)
    if ident is not None:
        return ident
    return f"{_HOST}:{os.getpid()}"


# ---------------------------------------------------------------------------
# trial lifecycle event trace
# ---------------------------------------------------------------------------

EV_CREATED = 0
EV_CLAIMED = 1
EV_REPORTED = 2
EV_PRUNED = 3
EV_COMPLETED = 4
EV_FAILED = 5

EVENT_KINDS = ("created", "claimed", "reported", "pruned", "completed", "failed")


class TrialEventLog:
    """Columnar append-only trial lifecycle trace for one study.

    Events live in parallel numpy columns (int8 kind, int64 trial number /
    step / monotonic-ns timestamp, interned worker-id index) that grow by
    doubling; ``snapshot(since)`` slices them into plain JSON lists so the
    trace crosses the remote protocol for free and incremental pollers fetch
    only the tail.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        cap = 64
        self._kind = np.empty(cap, dtype=np.int8)
        self._number = np.empty(cap, dtype=np.int64)
        self._step = np.empty(cap, dtype=np.int64)
        self._t_ns = np.empty(cap, dtype=np.int64)
        self._worker_idx = np.empty(cap, dtype=np.int32)
        self._workers: list[str] = []
        self._worker_ids: dict[str, int] = {}

    def __len__(self) -> int:
        return self._n

    def _grow(self) -> None:
        cap = len(self._kind) * 2
        for name in ("_kind", "_number", "_step", "_t_ns", "_worker_idx"):
            col = getattr(self, name)
            fresh = np.empty(cap, dtype=col.dtype)
            fresh[: self._n] = col[: self._n]
            setattr(self, name, fresh)

    def append(
        self, kind: int, number: int, step: int = -1, worker: str | None = None
    ) -> None:
        if worker is None:
            worker = worker_id()
        t = time.monotonic_ns()
        with self._lock:
            widx = self._worker_ids.get(worker)
            if widx is None:
                widx = len(self._workers)
                self._workers.append(worker)
                self._worker_ids[worker] = widx
            if self._n == len(self._kind):
                self._grow()
            i = self._n
            self._kind[i] = kind
            self._number[i] = number
            self._step[i] = step
            self._t_ns[i] = t
            self._worker_idx[i] = widx
            self._n = i + 1

    def snapshot(self, since: int = 0) -> dict[str, Any]:
        """Columns from event ``since`` on, as a JSON-safe wire dict."""
        with self._lock:
            n = self._n
            since = max(0, min(int(since), n))
            return {
                "since": since,
                "next": n,
                "kind": self._kind[since:n].tolist(),
                "number": self._number[since:n].tolist(),
                "step": self._step[since:n].tolist(),
                "t_ns": self._t_ns[since:n].tolist(),
                "worker_idx": self._worker_idx[since:n].tolist(),
                "workers": list(self._workers),
            }

    def rows(self) -> list[dict[str, Any]]:
        """Expanded per-event dicts (diagnostics / tests), oldest first."""
        snap = self.snapshot()
        return expand_events(snap)


def expand_events(snap: dict[str, Any]) -> list[dict[str, Any]]:
    """Turn a :meth:`TrialEventLog.snapshot` wire dict into per-event rows."""
    workers = snap.get("workers", [])
    out = []
    for kind, number, step, t_ns, widx in zip(
        snap["kind"], snap["number"], snap["step"], snap["t_ns"], snap["worker_idx"]
    ):
        out.append(
            {
                "event": EVENT_KINDS[kind],
                "number": int(number),
                "step": int(step),
                "t_ns": int(t_ns),
                "worker": workers[widx] if 0 <= widx < len(workers) else "?",
            }
        )
    return out


def _iter_event_tuples(snap: dict[str, Any]) -> Iterator[tuple[str, int, int]]:
    """(event, number, step) triples — the worker/time-independent trace."""
    for kind, number, step in zip(snap["kind"], snap["number"], snap["step"]):
        yield (EVENT_KINDS[kind], int(number), int(step))

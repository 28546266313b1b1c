"""One configured logger tree for ``repro_torch.core`` with study/worker context.

Module loggers keep their stdlib names (``repro_torch.core.study`` etc. — pinned by
caplog tests), but are obtained through :func:`get_logger` so they all hang
off one configured ``repro_torch`` root: a :class:`logging.NullHandler` by default
(library-quiet), upgraded to a context-rich stream handler by
:func:`configure` for CLIs and worker fleets.  Every record passing through
gets a ``worker`` attribute (``host:pid``, or the remote peer inside server
handlers) from :mod:`repro_torch.core.telemetry`.

Fallback warnings that would otherwise fire per-trial are funneled through
:func:`log_once` (exactly once per key, e.g. once per study) and
:class:`RateLimiter` (at most once per interval per key).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

from . import telemetry

__all__ = ["get_logger", "configure", "log_once", "reset_once", "RateLimiter"]

_FORMAT = "%(asctime)s %(levelname)s [%(worker)s] %(name)s: %(message)s"

_setup_lock = threading.Lock()
_configured = False


class _WorkerContextFilter(logging.Filter):
    """Stamp each record with the emitting worker's identity."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.worker = telemetry.worker_id()
        return True


def _ensure_root() -> logging.Logger:
    """Attach a NullHandler + worker filter to the ``repro_torch`` root exactly once
    (library default: quiet, but records still flow to caplog/user handlers)."""
    global _configured
    root = logging.getLogger("repro_torch")
    if not _configured:
        with _setup_lock:
            if not _configured:
                root.addFilter(_WorkerContextFilter())
                if not root.handlers:
                    root.addHandler(logging.NullHandler())
                _configured = True
    return root


def get_logger(name: str) -> logging.Logger:
    """Module logger under the configured ``repro_torch`` root; same stdlib names
    as ``logging.getLogger(__name__)`` so caplog filters keep working."""
    _ensure_root()
    return logging.getLogger(name)


def configure(level: int = logging.INFO) -> logging.Logger:
    """Opt-in CLI/worker setup: stream handler with worker context on the
    ``repro_torch`` root.  Idempotent — repeated calls only adjust the level."""
    root = _ensure_root()
    root.setLevel(level)
    for h in root.handlers:
        if isinstance(h, logging.StreamHandler) and not isinstance(
            h, logging.NullHandler
        ):
            h.setLevel(level)
            return root
    handler = logging.StreamHandler()
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    return root


# ---------------------------------------------------------------------------
# once-per-key / rate-limited emission
# ---------------------------------------------------------------------------

_once_lock = threading.Lock()
_once_seen: set = set()


def log_once(
    logger: logging.Logger, key: Any, level: int, msg: str, *args: Any
) -> bool:
    """Emit ``msg`` at ``level`` exactly once per ``key`` per process.

    The key carries the dedup scope — e.g. ``("joint_miss", id(study))`` for
    the once-per-study joint-sampling fallback.  Returns True when the record
    was actually emitted.
    """
    with _once_lock:
        if key in _once_seen:
            return False
        _once_seen.add(key)
    logger.log(level, msg, *args)
    return True


def reset_once(key: Any = None) -> None:
    """Forget one dedup key (or all of them) — test isolation hook."""
    with _once_lock:
        if key is None:
            _once_seen.clear()
        else:
            _once_seen.discard(key)


class RateLimiter:
    """At most one emission per ``interval`` seconds per key; drops (and
    counts) the rest.  For chatty retry/fallback paths in worker fleets."""

    def __init__(self, interval: float = 30.0):
        self.interval = float(interval)
        self._lock = threading.Lock()
        self._last: dict[Any, float] = {}
        self._dropped: dict[Any, int] = {}

    def log(
        self, logger: logging.Logger, key: Any, level: int, msg: str, *args: Any
    ) -> bool:
        now = time.monotonic()
        with self._lock:
            last = self._last.get(key)
            if last is not None and now - last < self.interval:
                self._dropped[key] = self._dropped.get(key, 0) + 1
                return False
            dropped = self._dropped.pop(key, 0)
            self._last[key] = now
        if dropped:
            msg = msg + " (%d similar suppressed)"
            args = args + (dropped,)
        logger.log(level, msg, *args)
        return True

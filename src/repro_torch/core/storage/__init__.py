"""Storage backends.  This slice of the port carries the in-memory backend
(the paper's lightweight default, §4); the URL backends (sqlite, journal,
remote, sharded) arrive with the storage slice."""

from __future__ import annotations

from .base import BaseStorage, StudySummary, get_trials_since
from .inmemory import InMemoryStorage

__all__ = [
    "BaseStorage",
    "StudySummary",
    "InMemoryStorage",
    "get_storage",
    "get_trials_since",
]


def get_storage(storage: "str | BaseStorage | None") -> BaseStorage:
    """``None`` -> a fresh :class:`InMemoryStorage`; a :class:`BaseStorage`
    passes through.  Storage URLs (``sqlite:///``, ``journal://``,
    ``remote://``) raise until the storage slice ports their backends."""
    if storage is None:
        return InMemoryStorage()
    if isinstance(storage, BaseStorage):
        return storage
    raise NotImplementedError(
        f"storage {storage!r}: the URL backends (sqlite, journal, remote, "
        "sharded) are not ported yet; they arrive with the storage slice"
    )

"""Storage backends (paper §4): in-memory (lightweight), SQLite (RDB),
append-only journal file (NFS-scale fleets), and a networked client/server
pair (``remote://``) for fleets without any shared filesystem.  See DESIGN.md
for the backend matrix and the remote protocol."""

from __future__ import annotations

from .base import BaseStorage, StudySummary, get_trials_since
from .cached import CachedStorage
from .client import RemoteStorage
from .cluster import ShardedStorage
from .inmemory import InMemoryStorage
from .journal import JournalStorage
from .server import StorageServer
from .sqlite import SQLiteStorage

__all__ = [
    "BaseStorage",
    "StudySummary",
    "InMemoryStorage",
    "SQLiteStorage",
    "JournalStorage",
    "RemoteStorage",
    "CachedStorage",
    "ShardedStorage",
    "StorageServer",
    "get_storage",
    "get_trials_since",
]


def get_storage(storage: "str | BaseStorage | None", cache: bool = False) -> BaseStorage:
    """Resolve a storage URL / object, mirroring the paper's Fig. 7 usage:

    * ``None``             -> fresh :class:`InMemoryStorage`
    * ``sqlite:///path``   -> :class:`SQLiteStorage`
    * ``journal://path``   -> :class:`JournalStorage`
    * ``remote://host:port`` -> :class:`RemoteStorage` speaking to a
      :class:`StorageServer` (no shared filesystem needed; see DESIGN.md)
    * ``remote://a:p1,b:p2`` (comma-sharded host list) ->
      :class:`ShardedStorage` consistent-hashing studies across a server
      pool; ``+`` within a shard lists failover candidates
    * ``*.db`` / ``*.sqlite`` path -> :class:`SQLiteStorage`
    * ``*.journal`` / ``*.log`` path -> :class:`JournalStorage`

    ``cache=True`` wraps the resolved backend in :class:`CachedStorage`, the
    client-side proxy that makes ``get_all_trials`` incremental (recommended
    for workers talking to a ``remote://`` server).
    """
    backend = _resolve(storage)
    if cache and not isinstance(backend, CachedStorage):
        backend = CachedStorage(backend)
    return backend


def _resolve(storage: "str | BaseStorage | None") -> BaseStorage:
    if storage is None:
        return InMemoryStorage()
    if isinstance(storage, BaseStorage):
        return storage
    if storage.startswith("sqlite:///"):
        return SQLiteStorage(storage)
    if storage.startswith("journal://"):
        return JournalStorage(storage)
    if storage.startswith(("remote://", "remote+tls://")):
        if "," in storage:
            return ShardedStorage(storage)
        return RemoteStorage(storage)
    if storage.endswith((".db", ".sqlite", ".sqlite3")):
        return SQLiteStorage(storage)
    if storage.endswith((".journal", ".log", ".jsonl")):
        return JournalStorage(storage)
    raise ValueError(
        f"cannot infer storage backend from {storage!r}; "
        "use sqlite:///, journal://, or remote:// URLs"
    )

"""Deterministic chaos harness for the storage service.

Fault injection lives *inside* the server reactor — no iptables, no proxies,
no timing races.  A :class:`FaultInjector` is handed to
:class:`~repro_torch.core.storage.server.StorageServer` and consulted at two
points of the event loop:

* ``on_accept()`` — just after ``accept()``; ``True`` drops the fresh
  connection before the client sees a single byte.
* ``on_frame()`` — after a request frame is fully decoded (and past auth);
  the verdict is applied to the *response*:

  - ``"drop_conn"``   — tear the connection down without answering (the
    request was **not** executed: the classic mid-flight cut),
  - ``"blackhole"``   — execute the request but discard the response (the
    nastiest case: a ``tell`` that *happened* but looks lost — exactly what
    the op-id dedup window exists for),
  - ``("delay", s)``  — answer after ``s`` seconds (reordering/timeout),
  - ``None``          — no fault.

Faults are armed by count (``drop_next_frames(2)``) or probabilistically
(``random_drop(0.01)``) from a seeded RNG, so a chaos run is exactly
reproducible.  :class:`ChaosCluster` bundles the rest of the lab: a sharded
server pool with optional replicas, one seeded injector per shard, and
kill / promote / restart controls for failover drills.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any

from .base import BaseStorage
from .cached import CachedStorage
from .client import RemoteStorage
from .cluster import ShardedStorage
from .inmemory import InMemoryStorage
from .server import StorageServer

__all__ = ["FaultInjector", "ChaosCluster"]


class FaultInjector:
    """Seeded, thread-safe fault schedule for one server's reactor.

    Counted rules fire once per matching event and then disarm; the
    probabilistic rule (``random_drop``) stays armed until ``clear()``.
    Counted rules take precedence over the probabilistic one, and at most
    one fault fires per frame, so schedules compose predictably.
    """

    def __init__(self, seed: "int | None" = None):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._drop_connects = 0
        self._drop_frames = 0
        self._blackholes = 0
        self._delays = 0
        self._delay_seconds = 0.0
        self._drop_rate = 0.0
        self.stats = {
            "dropped_connects": 0,
            "dropped_frames": 0,
            "blackholed_frames": 0,
            "delayed_frames": 0,
        }

    # -- arming ------------------------------------------------------------

    def drop_connects(self, n: int = 1) -> "FaultInjector":
        """Refuse the next ``n`` fresh connections at accept time."""
        with self._lock:
            self._drop_connects += int(n)
        return self

    def drop_next_frames(self, n: int = 1) -> "FaultInjector":
        """Cut the connection on the next ``n`` frames *before* executing
        them (request lost in flight)."""
        with self._lock:
            self._drop_frames += int(n)
        return self

    def blackhole_next(self, n: int = 1) -> "FaultInjector":
        """Execute the next ``n`` requests but swallow their responses
        (effect happened, client sees a dead connection)."""
        with self._lock:
            self._blackholes += int(n)
        return self

    def delay_next(self, n: int = 1, seconds: float = 0.2) -> "FaultInjector":
        """Hold the next ``n`` responses for ``seconds``."""
        with self._lock:
            self._delays += int(n)
            self._delay_seconds = float(seconds)
        return self

    def random_drop(self, rate: float) -> "FaultInjector":
        """Drop each frame (pre-execution) with probability ``rate``, from
        the injector's seeded RNG."""
        with self._lock:
            self._drop_rate = float(rate)
        return self

    def clear(self) -> None:
        """Disarm everything (counted and probabilistic)."""
        with self._lock:
            self._drop_connects = 0
            self._drop_frames = 0
            self._blackholes = 0
            self._delays = 0
            self._drop_rate = 0.0

    @property
    def armed(self) -> bool:
        with self._lock:
            return bool(
                self._drop_connects or self._drop_frames or self._blackholes
                or self._delays or self._drop_rate
            )

    # -- reactor hooks -----------------------------------------------------

    def on_accept(self) -> bool:
        with self._lock:
            if self._drop_connects > 0:
                self._drop_connects -= 1
                self.stats["dropped_connects"] += 1
                return True
        return False

    def on_frame(self) -> Any:
        with self._lock:
            if self._drop_frames > 0:
                self._drop_frames -= 1
                self.stats["dropped_frames"] += 1
                return "drop_conn"
            if self._blackholes > 0:
                self._blackholes -= 1
                self.stats["blackholed_frames"] += 1
                return "blackhole"
            if self._delays > 0:
                self._delays -= 1
                self.stats["delayed_frames"] += 1
                return ("delay", self._delay_seconds)
            if self._drop_rate > 0.0 and self._rng.random() < self._drop_rate:
                self.stats["dropped_frames"] += 1
                return "drop_conn"
        return None


class ChaosCluster:
    """A self-contained sharded storage lab: ``n_shards`` primaries (each
    with a seeded :class:`FaultInjector`), optional journal-replicated
    replicas, and failover controls.

    Args:
        n_shards: number of independent shards (1 = a single server).
        replicated: shard indices that also get a tailing replica.
        sync_replication: hold client write responses until the replica
            acks (the zero-lost-tells mode; see server.py).
        seed: base RNG seed; shard ``i``'s injector uses ``seed + i``.
        backend_factory: storage constructor per node (default
            :class:`InMemoryStorage`).
        reclaim_grace / reclaim_requeue: enable the server-side
            stale-RUNNING sweeper on every primary.
    """

    def __init__(
        self,
        n_shards: int = 2,
        replicated: "tuple[int, ...] | list[int]" = (),
        sync_replication: bool = True,
        seed: int = 0,
        auth_token: "str | None" = None,
        backend_factory: Any = InMemoryStorage,
        reclaim_grace: "float | None" = None,
        reclaim_requeue: bool = False,
        reclaim_interval: float = 1.0,
    ):
        self.injectors: list[FaultInjector] = []
        self.primaries: list[StorageServer] = []
        self.replicas: dict[int, StorageServer] = {}
        self._auth_token = auth_token
        replicated = set(replicated)
        for i in range(n_shards):
            inj = FaultInjector(seed=seed + i)
            primary = StorageServer(
                backend_factory(),
                auth_token=auth_token,
                journal=i in replicated,
                sync_replication=sync_replication and i in replicated,
                fault_injector=inj,
                reclaim_grace=reclaim_grace,
                reclaim_requeue=reclaim_requeue,
                reclaim_interval=reclaim_interval,
            )
            primary.start()
            self.injectors.append(inj)
            self.primaries.append(primary)
        for i in replicated:
            replica = StorageServer(
                backend_factory(),
                replicate_from=self.primaries[i].url,
                auth_token=auth_token,
            )
            replica.start()
            self.replicas[i] = replica

    # -- addressing --------------------------------------------------------

    def shard_netloc(self, i: int) -> str:
        """``host:port[+replica_host:port]`` — the failover candidate list
        of shard ``i`` (primary first, like a worker would be configured)."""
        loc = self.primaries[i].url.split("://", 1)[1]
        replica = self.replicas.get(i)
        if replica is not None:
            loc += "+" + replica.url.split("://", 1)[1]
        return loc

    @property
    def url(self) -> str:
        """The whole cluster as one ``remote://`` URL (shards comma-joined,
        failover candidates ``+``-joined)."""
        netlocs = ",".join(self.shard_netloc(i) for i in range(len(self.primaries)))
        token = f"{self._auth_token}@" if self._auth_token else ""
        return f"remote://{token}{netlocs}"

    def storage(self, cache: bool = False, **client_kwargs: Any) -> BaseStorage:
        """A client for the cluster: :class:`ShardedStorage` when there are
        multiple shards, a plain :class:`RemoteStorage` for one."""
        if len(self.primaries) > 1:
            st: BaseStorage = ShardedStorage(self.url, **client_kwargs)
        else:
            st = RemoteStorage(self.url, **client_kwargs)
        return CachedStorage(st) if cache else st

    # -- failure controls --------------------------------------------------

    def kill_primary(self, i: int) -> None:
        """Hard-kill shard ``i``'s primary: no flush, no goodbye — in-flight
        responses and buffered outbytes are gone."""
        self.primaries[i].kill()

    def promote_replica(self, i: int) -> StorageServer:
        """Promote shard ``i``'s replica to primary (next epoch).  Clients
        holding the shard's candidate list fail over on their next call."""
        replica = self.replicas[i]
        replica.promote()
        return replica

    def restart_primary(self, i: int) -> StorageServer:
        """Restart a killed primary on its original port, state intact (a
        crash-restart from snapshot).  If its replica was promoted meanwhile
        the old primary comes back *fenced*: its stale epoch makes every
        cluster-aware client refuse it."""
        return self.primaries[i].restart()

    def wait_replicated(self, i: int, timeout: float = 10.0) -> None:
        """Block until shard ``i``'s replica has applied every journaled op
        the primary has accepted (a write barrier for tests)."""
        primary, replica = self.primaries[i], self.replicas[i]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if replica.replication_state()["applied_seq"] >= primary.replication_state()["seq"]:
                return
            time.sleep(0.01)
        raise TimeoutError(
            f"shard {i} replica lag: primary seq "
            f"{primary.replication_state()['seq']}, replica applied "
            f"{replica.replication_state()['applied_seq']}"
        )

    def journal_seq(self, i: int) -> int:
        journal = self.primaries[i].journal
        return journal.end_seq if journal is not None else 0

    def stop(self) -> None:
        """Stop every node (kill-safe: already-killed primaries are fine)."""
        for replica in self.replicas.values():
            try:
                replica.stop()
            except Exception:
                pass
        for primary in self.primaries:
            try:
                primary.stop()
            except Exception:
                pass

    def __enter__(self) -> "ChaosCluster":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

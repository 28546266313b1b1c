"""``ShardedStorage`` — client-side shard router over a pool of storage nodes.

A ``remote://`` URL whose host list is comma-separated fans the study space
out over several independent :class:`~repro_torch.core.storage.server.StorageServer`
processes::

    remote://token@a:7000,b:7000,c:7000          # three shards
    remote://a:7000+a2:7001,b:7000               # shard 0 has a failover pair

Commas separate **shards** (different data); ``+`` separates **failover
candidates** of one shard (same data: primary, then replicas — handled
entirely inside :class:`~repro_torch.core.storage.client.RemoteStorage`).

Design points:

* **Study placement** — a study lives wholly on one shard, chosen by
  consistent-hashing its *name* (SHA-1 ring, 64 virtual nodes per shard).
  Placement is a pure function of (name, shard count), so every worker
  process routes identically with no coordination and no metadata service.
* **ID virtualization** — shard-local ids are interleaved into a global id
  space: ``gid = local * n_shards + shard``.  Decoding is arithmetic
  (``shard = gid % n``, ``local = gid // n``), so routing a trial id never
  needs a directory lookup.  Trial *numbers* are untouched — they are dense
  per study and a study never spans shards.
* **Full contract** — the router implements the complete
  :class:`BaseStorage` surface including the columnar block RPCs (only
  ``iv_block.trial_ids`` needs rewriting; observation blocks and trial-event
  traces are keyed by per-study numbers) and ``call_batch`` (calls are
  grouped per shard, flushed as one frame each, results re-assembled in
  request order).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, Iterable

from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseStorage, StudySummary
from .client import RemoteStorage

__all__ = ["ShardedStorage", "HashRing", "parse_sharded_url"]


def parse_sharded_url(url: str) -> list[str]:
    """Split a comma-sharded ``remote://`` URL into one URL per shard, each
    keeping the scheme and (token) userinfo: ``remote://t@a:1,b:2`` ->
    ``["remote://t@a:1", "remote://t@b:2"]``."""
    for scheme in ("remote+tls://", "remote://"):
        if url.startswith(scheme):
            rest = url[len(scheme):].rstrip("/")
            break
    else:
        raise ValueError(f"not a remote:// URL: {url!r}")
    userinfo = ""
    if "@" in rest:
        userinfo, _, rest = rest.rpartition("@")
        userinfo += "@"
    shards = [part for part in rest.split(",") if part]
    if not shards:
        raise ValueError(f"sharded remote:// URL has no shards: {url!r}")
    return [f"{scheme}{userinfo}{part}" for part in shards]


class HashRing:
    """Consistent-hash ring: SHA-1 points, ``vnodes`` virtual nodes per
    shard.  Stable across processes and Python runs (no randomized hashing),
    so every worker computes the same placement."""

    def __init__(self, n_shards: int, vnodes: int = 64):
        points: list[tuple[int, int]] = []
        for shard in range(n_shards):
            for v in range(vnodes):
                points.append((self._hash(f"shard:{shard}:vnode:{v}"), shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [s for _, s in points]

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")

    def lookup(self, key: str) -> int:
        i = bisect.bisect(self._hashes, self._hash(key)) % len(self._hashes)
        return self._owners[i]


# batched methods whose first param is a trial id (routed arithmetically)
_TID_FIRST = frozenset(
    {
        "set_trial_param",
        "set_trial_state_values",
        "set_trial_intermediate_value",
        "set_trial_user_attr",
        "set_trial_system_attr",
        "get_trial",
        "record_heartbeat",
    }
)


class ShardedStorage(BaseStorage):
    """Route :class:`BaseStorage` calls across a pool of storage servers.

    Args:
        url: comma-sharded ``remote://`` URL (see module docstring), or a
            pre-split list of one URL per shard.  Shard order is part of the
            id encoding — every worker must list shards identically.
        **client_kwargs: forwarded to every per-shard
            :class:`RemoteStorage` (``timeout``, ``retries``,
            ``rpc_deadline``, ``auth_token``, ``backoff_seed``, ...).
    """

    def __init__(self, url: "str | list[str]", **client_kwargs: Any):
        urls = parse_sharded_url(url) if isinstance(url, str) else list(url)
        if not urls:
            raise ValueError("ShardedStorage needs at least one shard URL")
        self._shards: list[RemoteStorage] = [
            RemoteStorage(u, **client_kwargs) for u in urls
        ]
        self._n = len(self._shards)
        self._ring = HashRing(self._n)
        self._url = ",".join(s.url for s in self._shards)

    @property
    def url(self) -> str:
        return self._url

    @property
    def n_shards(self) -> int:
        return self._n

    @property
    def shards(self) -> list[RemoteStorage]:
        return list(self._shards)

    @property
    def supports_block_fetch(self) -> bool:
        return all(s.supports_block_fetch for s in self._shards)

    # -- id virtualization ------------------------------------------------------

    def _gid(self, local_id: int, shard: int) -> int:
        return local_id * self._n + shard

    def _split(self, gid: int) -> tuple[int, int]:
        """global id -> (shard index, shard-local id)"""
        gid = int(gid)
        return gid % self._n, gid // self._n

    def shard_of_study(self, study_name: str) -> int:
        return self._ring.lookup(study_name)

    def _globalize_trial(self, t: FrozenTrial, shard: int) -> FrozenTrial:
        t._trial_id = self._gid(t._trial_id, shard)
        return t

    # -- study -----------------------------------------------------------------

    def create_new_study(self, directions: list[StudyDirection], study_name: str) -> int:
        shard = self._ring.lookup(study_name)
        return self._gid(self._shards[shard].create_new_study(directions, study_name), shard)

    def delete_study(self, study_id: int) -> None:
        shard, sid = self._split(study_id)
        self._shards[shard].delete_study(sid)

    def get_study_id_from_name(self, study_name: str) -> int:
        shard = self._ring.lookup(study_name)
        return self._gid(self._shards[shard].get_study_id_from_name(study_name), shard)

    def get_study_name_from_id(self, study_id: int) -> str:
        shard, sid = self._split(study_id)
        return self._shards[shard].get_study_name_from_id(sid)

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        shard, sid = self._split(study_id)
        return self._shards[shard].get_study_directions(sid)

    def get_all_studies(self) -> list[StudySummary]:
        out: list[StudySummary] = []
        for shard, client in enumerate(self._shards):
            for summary in client.get_all_studies():
                summary.study_id = self._gid(summary.study_id, shard)
                out.append(summary)
        return out

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        shard, sid = self._split(study_id)
        self._shards[shard].set_study_user_attr(sid, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        shard, sid = self._split(study_id)
        self._shards[shard].set_study_system_attr(sid, key, value)

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        shard, sid = self._split(study_id)
        return self._shards[shard].get_study_user_attrs(sid)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        shard, sid = self._split(study_id)
        return self._shards[shard].get_study_system_attrs(sid)

    # -- trial -----------------------------------------------------------------

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        shard, sid = self._split(study_id)
        return self._gid(self._shards[shard].create_new_trial(sid, template_trial), shard)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        shard, sid = self._split(study_id)
        return [
            self._gid(tid, shard)
            for tid in self._shards[shard].create_new_trials(sid, n, template_trial)
        ]

    def set_trial_param(
        self, trial_id: int, param_name: str, param_value_internal: float, distribution
    ) -> None:
        shard, tid = self._split(trial_id)
        self._shards[shard].set_trial_param(tid, param_name, param_value_internal, distribution)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        shard, tid = self._split(trial_id)
        return self._shards[shard].set_trial_state_values(tid, state, values)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        shard, tid = self._split(trial_id)
        self._shards[shard].set_trial_intermediate_value(tid, step, intermediate_value)

    def report_and_prune(
        self, study_id: int, trial_id: int, step: int, value: float,
        pruner_spec: dict, direction,
    ) -> bool:
        shard, sid = self._split(study_id)
        _, tid = self._split(trial_id)
        return self._shards[shard].report_and_prune(sid, tid, step, value, pruner_spec, direction)

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        shard, tid = self._split(trial_id)
        self._shards[shard].set_trial_user_attr(tid, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        shard, tid = self._split(trial_id)
        self._shards[shard].set_trial_system_attr(tid, key, value)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        shard, tid = self._split(trial_id)
        return self._globalize_trial(self._shards[shard].get_trial(tid), shard)

    def get_all_trials(
        self, study_id: int, deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        shard, sid = self._split(study_id)
        trials = self._shards[shard].get_all_trials(sid, deepcopy, states, since)
        return [self._globalize_trial(t, shard) for t in trials]

    def get_n_trials(self, study_id: int, states: tuple[TrialState, ...] | None = None) -> int:
        shard, sid = self._split(study_id)
        return self._shards[shard].get_n_trials(sid, states)

    def get_trial_id_from_study_and_number(self, study_id: int, number: int) -> int:
        shard, sid = self._split(study_id)
        return self._gid(
            self._shards[shard].get_trial_id_from_study_and_number(sid, number), shard
        )

    def get_trials_revision(self, study_id: int) -> int:
        shard, sid = self._split(study_id)
        return self._shards[shard].get_trials_revision(sid)

    # -- columnar block fetch -----------------------------------------------------

    def get_observation_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        # keyed by per-study trial numbers: nothing to rewrite
        shard, sid = self._split(study_id)
        return self._shards[shard].get_observation_block(sid, since)

    def get_iv_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        shard, sid = self._split(study_id)
        block = self._shards[shard].get_iv_block(sid, since)
        ids = block.get("trial_ids")
        if ids is not None:
            if isinstance(ids, list):
                block["trial_ids"] = [self._gid(t, shard) for t in ids]
            else:  # numpy column straight off the v2 wire
                block["trial_ids"] = ids * self._n + shard
        return block

    # -- heartbeat ---------------------------------------------------------------

    def record_heartbeat(self, trial_id: int) -> None:
        shard, tid = self._split(trial_id)
        self._shards[shard].record_heartbeat(tid)

    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        shard, sid = self._split(study_id)
        return [
            self._gid(t, shard)
            for t in self._shards[shard].get_stale_trial_ids(sid, grace_seconds)
        ]

    def fail_stale_trials(self, study_id: int, grace_seconds: float) -> list[int]:
        shard, sid = self._split(study_id)
        return [
            self._gid(t, shard)
            for t in self._shards[shard].fail_stale_trials(sid, grace_seconds)
        ]

    def reclaim_stale_trials(
        self, study_id: int, grace_seconds: float, requeue: bool = False
    ) -> list[int]:
        shard, sid = self._split(study_id)
        return [
            self._gid(t, shard)
            for t in self._shards[shard].reclaim_stale_trials(sid, grace_seconds, requeue)
        ]

    # -- telemetry ---------------------------------------------------------------

    def get_trial_events(self, study_id: int, since: int = 0) -> dict[str, Any]:
        # keyed by per-study trial numbers: nothing to rewrite
        shard, sid = self._split(study_id)
        return self._shards[shard].get_trial_events(sid, since)

    def get_server_metrics(self) -> dict[str, Any]:
        return {"shards": [s.get_server_metrics() for s in self._shards]}

    # -- batching ----------------------------------------------------------------

    def call_batch(self, calls: list[tuple[str, tuple]]) -> list[Any]:
        """Per-shard request batching: calls are routed by their embedded
        study/trial id, sent as ONE frame per touched shard, and the results
        re-assembled in request order (ids in results re-globalized)."""
        routed: dict[int, list[tuple[int, str, tuple]]] = {}
        for pos, (method, params) in enumerate(calls):
            shard, local = self._translate_call(method, params)
            routed.setdefault(shard, []).append((pos, method, local))
        results: list[Any] = [None] * len(calls)
        for shard, entries in routed.items():
            batch = [(m, p) for _, m, p in entries]
            out = self._shards[shard].call_batch(batch)
            for (pos, method, _), res in zip(entries, out):
                results[pos] = self._translate_result(method, res, shard)
        return results

    def _translate_call(self, method: str, params: tuple) -> tuple[int, tuple]:
        params = tuple(params)
        if method in _TID_FIRST:
            shard, tid = self._split(params[0])
            return shard, (tid,) + params[1:]
        if method == "report_and_prune":
            shard, sid = self._split(params[0])
            _, tid = self._split(params[1])
            return shard, (sid, tid) + params[2:]
        if method in (
            "create_new_trial", "create_new_trials", "get_all_trials", "get_n_trials",
            "get_trial_id_from_study_and_number", "get_trials_revision",
            "get_observation_block", "get_iv_block", "get_trial_events",
            "get_stale_trial_ids", "fail_stale_trials", "reclaim_stale_trials",
            "delete_study", "get_study_name_from_id", "get_study_directions",
            "set_study_user_attr", "set_study_system_attr",
            "get_study_user_attrs", "get_study_system_attrs",
        ):
            shard, sid = self._split(params[0])
            return shard, (sid,) + params[1:]
        raise ValueError(f"cannot route batched method {method!r} across shards")

    def _translate_result(self, method: str, result: Any, shard: int) -> Any:
        if method in ("create_new_trial", "get_trial_id_from_study_and_number"):
            return self._gid(result, shard)
        if method in ("create_new_trials", "get_stale_trial_ids",
                      "fail_stale_trials", "reclaim_stale_trials"):
            return [self._gid(t, shard) for t in result]
        if method == "get_trial":
            return self._globalize_trial(result, shard)
        if method == "get_all_trials":
            return [self._globalize_trial(t, shard) for t in result]
        return result

    # -- misc ---------------------------------------------------------------------

    def close(self) -> None:
        for s in self._shards:
            s.close()

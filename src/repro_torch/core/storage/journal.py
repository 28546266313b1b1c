"""Append-only journal-file storage.

``sqlite`` over NFS is unreliable (POSIX lock emulation); at pod scale the
robust shared-filesystem design is an *append-only operation log* guarded by
``fcntl`` range locks — every write appends one JSON line; every read replays
the suffix of the log it has not seen.  This is the storage we recommend for
1000+ worker fleets without a DB host.  (Modern Optuna reached the same
conclusion with its ``JournalStorage``.)

Crash-safety: every append is fsync'd by default (``fsync=False`` — or a
``journal://path?fsync=0`` URL — trades the guarantee for throughput on
fast local disks).  A torn final line (a worker died mid-write) is invisible
to readers — they only consume up to the final newline — and is *repaired*
on the next append: whoever takes the exclusive lock truncates the torn tail
(with a warning) before writing, so the log can never glue two half-lines
together.  Corrupt interior lines are skipped with a warning.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
import warnings
from typing import Any, Iterable

from .. import telemetry as _telemetry
from ..distributions import (
    BaseDistribution,
    check_distribution_compatibility,
    distribution_to_json,
    json_to_distribution,
)
from ..exceptions import (
    DuplicatedStudyError,
    StudyNotFoundError,
    TrialNotFoundError,
)
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseStorage, StudySummary

try:
    import fcntl

    _HAS_FCNTL = True
except ImportError:  # pragma: no cover - non-posix
    _HAS_FCNTL = False

__all__ = ["JournalStorage"]


def _dt(ts: float):
    import datetime

    return datetime.datetime.fromtimestamp(ts)

# op codes
_CREATE_STUDY = "create_study"
_DELETE_STUDY = "delete_study"
_CREATE_TRIAL = "create_trial"
_SET_PARAM = "set_param"
_SET_STATE = "set_state"
_SET_IV = "set_iv"
_SET_TATTR = "set_tattr"
_SET_SATTR = "set_sattr"
_HEARTBEAT = "heartbeat"


class _FileLock:
    """Advisory exclusive lock on <path>.lock (fcntl; degrades to a process
    lock where fcntl is unavailable)."""

    def __init__(self, path: str):
        self._path = path + ".lock"
        self._tlock = threading.Lock()
        self._fd: int | None = None

    def __enter__(self):
        self._tlock.acquire()
        if _HAS_FCNTL:
            self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
        self._tlock.release()
        return False


class _Replay:
    """In-memory state rebuilt by replaying the journal."""

    def __init__(self):
        self.studies: dict[int, dict] = {}
        self.name_to_id: dict[str, int] = {}
        self.trials: dict[int, FrozenTrial] = {}
        self.study_trials: dict[int, list[int]] = {}
        self.trial_study: dict[int, int] = {}
        self.heartbeats: dict[int, float] = {}
        self.revisions: dict[int, int] = {}  # study_id -> trial-mutation count
        self.next_study_id = 0
        self.next_trial_id = 0

    def _bump(self, trial_id: int) -> None:
        sid = self.trial_study.get(trial_id)
        if sid is not None:
            self.revisions[sid] = self.revisions.get(sid, 0) + 1

    def apply(self, op: dict) -> None:
        kind = op["op"]
        if kind == _CREATE_STUDY:
            sid = op["study_id"]
            self.studies[sid] = {
                "name": op["name"],
                "directions": [StudyDirection(d) for d in op["directions"]],
                "user_attrs": {},
                "system_attrs": {},
            }
            self.name_to_id[op["name"]] = sid
            self.study_trials[sid] = []
            self.next_study_id = max(self.next_study_id, sid + 1)
        elif kind == _DELETE_STUDY:
            sid = op["study_id"]
            if sid in self.studies:
                self.name_to_id.pop(self.studies[sid]["name"], None)
                for tid in self.study_trials.pop(sid, []):
                    self.trials.pop(tid, None)
                    self.trial_study.pop(tid, None)
                self.revisions.pop(sid, None)
                del self.studies[sid]
        elif kind == _CREATE_TRIAL:
            tid = op["trial_id"]
            sid = op["study_id"]
            if sid not in self.studies:
                return
            number = len(self.study_trials[sid])
            t = FrozenTrial(
                number=number,
                state=TrialState(op["state"]),
                values=op.get("values"),
                trial_id=tid,
                datetime_start=(
                    _dt(op["ts"]) if "ts" in op and op["state"] != int(TrialState.WAITING) else None
                ),
            )
            t.system_attrs["journal:study_id"] = sid
            for name, (val, dist_json) in op.get("params", {}).items():
                dist = json_to_distribution(dist_json)
                t.params[name] = dist.to_external_repr(val)
                t.distributions[name] = dist
            for k, v in op.get("user_attrs", {}).items():
                t.user_attrs[k] = v
            for k, v in op.get("system_attrs", {}).items():
                t.system_attrs[k] = v
            self.trials[tid] = t
            self.study_trials[sid].append(tid)
            self.trial_study[tid] = sid
            self.next_trial_id = max(self.next_trial_id, tid + 1)
            self._bump(tid)
        elif kind == _SET_PARAM:
            t = self.trials.get(op["trial_id"])
            if t is None:
                return
            dist = json_to_distribution(op["dist"])
            t.params[op["name"]] = dist.to_external_repr(op["value"])
            t.distributions[op["name"]] = dist
            self._bump(op["trial_id"])
        elif kind == _SET_STATE:
            t = self.trials.get(op["trial_id"])
            if t is None:
                return
            new_state = TrialState(op["state"])
            if new_state == TrialState.RUNNING and t.state != TrialState.WAITING:
                return  # lost claim; replay keeps first claimant
            t.state = new_state
            if op.get("values") is not None:
                t.values = op["values"]
            if "ts" in op:
                if new_state == TrialState.RUNNING:
                    t.datetime_start = _dt(op["ts"])
                elif new_state.is_finished():
                    t.datetime_complete = _dt(op["ts"])
            self._bump(op["trial_id"])
        elif kind == _SET_IV:
            t = self.trials.get(op["trial_id"])
            if t is not None:
                t.intermediate_values[int(op["step"])] = op["value"]
                self._bump(op["trial_id"])
        elif kind == _SET_TATTR:
            t = self.trials.get(op["trial_id"])
            if t is not None:
                (t.system_attrs if op["sys"] else t.user_attrs)[op["key"]] = op["value"]
                self._bump(op["trial_id"])
        elif kind == _SET_SATTR:
            s = self.studies.get(op["study_id"])
            if s is not None:
                s["system_attrs" if op["sys"] else "user_attrs"][op["key"]] = op["value"]
        elif kind == _HEARTBEAT:
            self.heartbeats[op["trial_id"]] = op["t"]


class JournalStorage(BaseStorage):
    def __init__(self, path: str, fsync: bool = True):
        if path.startswith("journal://"):
            path = path[len("journal://"):]
        if "?" in path:
            path, _, query = path.partition("?")
            for kv in query.split("&"):
                k, _, v = kv.partition("=")
                if k == "fsync":
                    fsync = v not in ("0", "false", "no")
        self._path = path
        self._fsync = fsync
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = _FileLock(path)
        self._worker_id = uuid.uuid4().hex[:12]
        self._offset = 0
        self._replay = _Replay()
        self._mem_lock = threading.RLock()
        with self._lock:
            if not os.path.exists(path):
                with open(path, "a"):
                    pass
        self._sync()

    # -- journal io -------------------------------------------------------------

    def _sync_locked(self) -> None:
        """Replay any journal suffix we have not seen (caller holds file lock)."""
        with open(self._path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        if not data:
            return
        # only consume up to the final newline (a torn last line is in-flight)
        end = data.rfind(b"\n")
        if end < 0:
            return
        chunk = data[: end + 1]
        for line in chunk.splitlines():
            if not line.strip():
                continue
            try:
                op = json.loads(line)
            except json.JSONDecodeError:
                # a crash can only tear the FINAL line (appends are atomic
                # under the lock), so interior garbage means external damage
                warnings.warn(
                    f"journal {self._path}: skipping corrupt line "
                    f"({line[:80]!r}...)", RuntimeWarning, stacklevel=4,
                )
                _telemetry.inc("journal.corrupt_lines")
                continue
            self._replay.apply(op)
        self._offset += len(chunk)

    def _sync(self) -> None:
        with self._mem_lock, self._lock:
            self._sync_locked()

    def _repair_torn_tail_locked(self) -> None:
        """Truncate a torn final line before appending (caller holds BOTH
        locks and has just run ``_sync_locked``, so ``_offset`` sits at the
        last complete line).  Under the exclusive flock nobody can be
        mid-append, so any bytes past the final newline are a dead writer's
        half-finished line — appending after them would fuse two records."""
        try:
            size = os.path.getsize(self._path)
        except OSError:
            return
        if size > self._offset:
            warnings.warn(
                f"journal {self._path}: truncating {size - self._offset} "
                "bytes of torn final line left by a crashed writer",
                RuntimeWarning, stacklevel=4,
            )
            _telemetry.inc("journal.torn_truncates")
            os.truncate(self._path, self._offset)

    def _write_locked(self, line: str) -> None:
        with open(self._path, "a") as f:
            f.write(line)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())

    def _append(self, op: dict) -> None:
        line = json.dumps(op, separators=(",", ":")) + "\n"
        with self._mem_lock, self._lock:
            self._sync_locked()
            self._repair_torn_tail_locked()
            self._write_locked(line)
            self._replay.apply(op)
            self._offset += len(line.encode())

    def _append_with(self, make_op) -> Any:
        """Append an op computed under the lock (for atomic id/number assignment)."""
        with self._mem_lock, self._lock:
            self._sync_locked()
            self._repair_torn_tail_locked()
            op, result = make_op(self._replay)
            line = json.dumps(op, separators=(",", ":")) + "\n"
            self._write_locked(line)
            self._replay.apply(op)
            self._offset += len(line.encode())
            return result

    # -- study --------------------------------------------------------------------

    def create_new_study(self, directions: list[StudyDirection], study_name: str) -> int:
        def op(rep: _Replay):
            if study_name in rep.name_to_id:
                raise DuplicatedStudyError(study_name)
            sid = rep.next_study_id
            return (
                {"op": _CREATE_STUDY, "study_id": sid, "name": study_name,
                 "directions": [int(d) for d in directions]},
                sid,
            )

        return self._append_with(op)

    def delete_study(self, study_id: int) -> None:
        self._append({"op": _DELETE_STUDY, "study_id": study_id})
        self._drop_intermediate_store(study_id)
        self._drop_event_log(study_id)

    def get_study_id_from_name(self, study_name: str) -> int:
        self._sync()
        with self._mem_lock:
            if study_name not in self._replay.name_to_id:
                raise StudyNotFoundError(study_name)
            return self._replay.name_to_id[study_name]

    def get_study_name_from_id(self, study_id: int) -> str:
        self._sync()
        with self._mem_lock:
            self._check_study(study_id)
            return self._replay.studies[study_id]["name"]

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        self._sync()
        with self._mem_lock:
            self._check_study(study_id)
            return list(self._replay.studies[study_id]["directions"])

    def get_all_studies(self) -> list[StudySummary]:
        self._sync()
        with self._mem_lock:
            return [
                StudySummary(
                    sid, s["name"], list(s["directions"]),
                    len(self._replay.study_trials.get(sid, [])),
                    dict(s["user_attrs"]), dict(s["system_attrs"]),
                )
                for sid, s in self._replay.studies.items()
            ]

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._append({"op": _SET_SATTR, "study_id": study_id, "sys": 0, "key": key, "value": value})

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._append({"op": _SET_SATTR, "study_id": study_id, "sys": 1, "key": key, "value": value})

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        self._sync()
        with self._mem_lock:
            self._check_study(study_id)
            return dict(self._replay.studies[study_id]["user_attrs"])

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        self._sync()
        with self._mem_lock:
            self._check_study(study_id)
            return dict(self._replay.studies[study_id]["system_attrs"])

    def _check_study(self, study_id: int) -> None:
        if study_id not in self._replay.studies:
            raise StudyNotFoundError(study_id)

    # -- trial ----------------------------------------------------------------------

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        def op(rep: _Replay):
            if study_id not in rep.studies:
                raise StudyNotFoundError(study_id)
            tid = rep.next_trial_id
            body: dict[str, Any] = {
                "op": _CREATE_TRIAL, "trial_id": tid, "study_id": study_id,
                "state": int(template_trial.state if template_trial else TrialState.RUNNING),
                "ts": time.time(),
            }
            if template_trial is not None:
                if template_trial.values:
                    body["values"] = template_trial.values
                body["params"] = {
                    name: (dist.to_internal_repr(template_trial.params[name]),
                           distribution_to_json(dist))
                    for name, dist in template_trial.distributions.items()
                }
                body["user_attrs"] = template_trial.user_attrs
                body["system_attrs"] = template_trial.system_attrs
            return body, tid

        tid = self._append_with(op)
        with self._mem_lock:
            number = self._replay.trials[tid].number
        self._record_event(study_id, _telemetry.EV_CREATED, number)
        return tid

    def set_trial_param(
        self, trial_id: int, param_name: str, param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        with self._mem_lock:
            t = self._trial(trial_id)
            if t.state.is_finished():
                raise RuntimeError(f"trial {trial_id} is already finished")
            if param_name in t.distributions:
                check_distribution_compatibility(t.distributions[param_name], distribution)
        self._append({
            "op": _SET_PARAM, "trial_id": trial_id, "name": param_name,
            "value": float(param_value_internal), "dist": distribution_to_json(distribution),
        })

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        def op(rep: _Replay):
            t = rep.trials.get(trial_id)
            if t is None:
                raise TrialNotFoundError(trial_id)
            ok = not (state == TrialState.RUNNING and t.state != TrialState.WAITING)
            body = {
                "op": _SET_STATE, "trial_id": trial_id, "state": int(state),
                "values": [float(v) for v in values] if values is not None else None,
                "by": self._worker_id,
                "ts": time.time(),
            }
            return body, ok

        ok = self._append_with(op)
        if ok:
            with self._mem_lock:
                sid = self._replay.trial_study.get(trial_id)
                number = self._replay.trials[trial_id].number
            if sid is not None:
                self._record_state_event(sid, state, number)
        return ok

    def set_trial_intermediate_value(self, trial_id: int, step: int, intermediate_value: float) -> None:
        with self._mem_lock:
            t = self._trial(trial_id)
            if t.state.is_finished():
                raise RuntimeError(f"trial {trial_id} is already finished")
        self._append({
            "op": _SET_IV, "trial_id": trial_id, "step": int(step),
            "value": float(intermediate_value),
        })
        with self._mem_lock:
            sid = self._replay.trial_study.get(trial_id)
            number = self._replay.trials[trial_id].number
        self._note_iv_dirty(trial_id, sid)  # after append: stores lock store-first
        if sid is not None:
            self._record_event(sid, _telemetry.EV_REPORTED, number, step=int(step))

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._append({"op": _SET_TATTR, "trial_id": trial_id, "sys": 0, "key": key, "value": value})

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._append({"op": _SET_TATTR, "trial_id": trial_id, "sys": 1, "key": key, "value": value})

    def _trial(self, trial_id: int) -> FrozenTrial:
        if trial_id not in self._replay.trials:
            raise TrialNotFoundError(trial_id)
        return self._replay.trials[trial_id]

    def get_trial(self, trial_id: int) -> FrozenTrial:
        self._sync()
        with self._mem_lock:
            return self._trial(trial_id).copy()

    def get_all_trials(
        self, study_id: int, deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        self._sync()
        with self._mem_lock:
            self._check_study(study_id)
            tids = self._replay.study_trials[study_id]
            if since is not None:
                tids = tids[since:]  # study_trials is ordered by number
            ts = [self._replay.trials[tid] for tid in tids]
            if states is not None:
                ts = [t for t in ts if t.state in states]
            return [t.copy() for t in ts] if deepcopy else ts

    def get_trials_revision(self, study_id: int) -> int:
        # the journal must be replayed to learn the revision, so this does not
        # avoid I/O like the RDB/in-memory counters do — but it keeps the
        # revision *semantics* uniform across backends (every trial mutation,
        # including in-place RUNNING updates, bumps it exactly once)
        self._sync()
        with self._mem_lock:
            self._check_study(study_id)
            return self._replay.revisions.get(study_id, 0)

    # -- heartbeat --------------------------------------------------------------------

    def record_heartbeat(self, trial_id: int) -> None:
        self._append({"op": _HEARTBEAT, "trial_id": trial_id, "t": time.time()})

    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        self._sync()
        now = time.time()
        with self._mem_lock:
            out = []
            for tid in self._replay.study_trials.get(study_id, []):
                t = self._replay.trials[tid]
                hb = self._replay.heartbeats.get(tid)
                if t.state == TrialState.RUNNING and hb is not None and now - hb > grace_seconds:
                    out.append(tid)
            return out

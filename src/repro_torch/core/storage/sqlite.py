"""SQLite-backed storage — the paper's ``sqlite:///...`` distributed backend.

Multiple worker *processes* (possibly on different nodes over a shared
filesystem for small fleets, or one DB host) coordinate through this backend
exactly as in paper Fig. 7: run the same script N times with the same storage
URL and study name.

Implementation notes:

* WAL journal mode + ``busy_timeout`` + IMMEDIATE transactions for writers.
* Trial ``number`` assignment happens inside the INSERT transaction, so
  numbers are dense and unique under concurrency.
* All values stored as floats/JSON (internal reprs; see distributions.py).
* Retries with exponential backoff on ``database is locked``.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import sqlite3
import threading
import time
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
    StorageInternalError,
    StudyNotFoundError,
    TrialNotFoundError,
)
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseStorage, StudySummary

__all__ = ["SQLiteStorage"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS studies (
    study_id   INTEGER PRIMARY KEY AUTOINCREMENT,
    study_name TEXT UNIQUE NOT NULL,
    directions TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS study_attrs (
    study_id INTEGER NOT NULL,
    is_system INTEGER NOT NULL,
    key TEXT NOT NULL,
    value_json TEXT,
    PRIMARY KEY (study_id, is_system, key)
);
CREATE TABLE IF NOT EXISTS trials (
    trial_id  INTEGER PRIMARY KEY AUTOINCREMENT,
    study_id  INTEGER NOT NULL,
    number    INTEGER NOT NULL,
    state     INTEGER NOT NULL,
    values_json TEXT,
    datetime_start TEXT,
    datetime_complete TEXT,
    UNIQUE (study_id, number)
);
CREATE INDEX IF NOT EXISTS idx_trials_study ON trials (study_id);
CREATE TABLE IF NOT EXISTS trial_params (
    trial_id INTEGER NOT NULL,
    param_name TEXT NOT NULL,
    param_value REAL NOT NULL,
    distribution_json TEXT NOT NULL,
    PRIMARY KEY (trial_id, param_name)
);
CREATE TABLE IF NOT EXISTS trial_intermediate_values (
    trial_id INTEGER NOT NULL,
    step INTEGER NOT NULL,
    value REAL,
    PRIMARY KEY (trial_id, step)
);
CREATE TABLE IF NOT EXISTS trial_attrs (
    trial_id INTEGER NOT NULL,
    is_system INTEGER NOT NULL,
    key TEXT NOT NULL,
    value_json TEXT,
    PRIMARY KEY (trial_id, is_system, key)
);
CREATE TABLE IF NOT EXISTS trial_heartbeats (
    trial_id INTEGER PRIMARY KEY,
    heartbeat_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS study_revisions (
    study_id INTEGER PRIMARY KEY,
    revision INTEGER NOT NULL
);
"""

_MAX_RETRIES = 16


def _retry(fn):
    def wrapper(*args, **kwargs):
        delay = 0.005
        for attempt in range(_MAX_RETRIES):
            try:
                return fn(*args, **kwargs)
            except sqlite3.OperationalError as e:
                if "locked" not in str(e) and "busy" not in str(e):
                    raise
                if attempt == _MAX_RETRIES - 1:
                    raise StorageInternalError(f"sqlite stayed locked: {e}") from e
                time.sleep(delay)
                delay = min(delay * 2, 0.5)

    wrapper.__name__ = fn.__name__
    return wrapper


class SQLiteStorage(BaseStorage):
    """Storage over a sqlite database file.

    Accepts either a filesystem path or a ``sqlite:///path`` URL.
    """

    def __init__(self, url_or_path: str):
        path = url_or_path
        if path.startswith("sqlite:///"):
            path = path[len("sqlite:///"):]
        self._path = path or ":memory:"
        if self._path != ":memory:":
            d = os.path.dirname(os.path.abspath(self._path))
            os.makedirs(d, exist_ok=True)
        self._local = threading.local()
        self._conn().executescript(_SCHEMA)

    # one connection per thread; sqlite connections are not thread-safe
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path, timeout=30.0, isolation_level=None)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._local.conn = conn
        return conn

    class _Tx:
        def __init__(self, conn: sqlite3.Connection, immediate: bool):
            self.conn = conn
            self.immediate = immediate

        def __enter__(self) -> sqlite3.Cursor:
            self.cur = self.conn.cursor()
            self.cur.execute("BEGIN IMMEDIATE" if self.immediate else "BEGIN")
            return self.cur

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self.conn.execute("COMMIT")
            else:
                self.conn.execute("ROLLBACK")
            self.cur.close()
            return False

    def _tx(self, immediate: bool = True) -> "_Tx":
        return SQLiteStorage._Tx(self._conn(), immediate)

    # -- study ---------------------------------------------------------------

    @_retry
    def create_new_study(self, directions: list[StudyDirection], study_name: str) -> int:
        try:
            with self._tx() as cur:
                cur.execute(
                    "INSERT INTO studies (study_name, directions) VALUES (?, ?)",
                    (study_name, json.dumps([int(d) for d in directions])),
                )
                return cur.lastrowid
        except sqlite3.IntegrityError:
            raise DuplicatedStudyError(study_name)

    @_retry
    def delete_study(self, study_id: int) -> None:
        with self._tx() as cur:
            cur.execute("SELECT trial_id FROM trials WHERE study_id=?", (study_id,))
            tids = [r[0] for r in cur.fetchall()]
            for table in ("trial_params", "trial_intermediate_values", "trial_attrs", "trial_heartbeats"):
                cur.executemany(f"DELETE FROM {table} WHERE trial_id=?", [(t,) for t in tids])
            cur.execute("DELETE FROM trials WHERE study_id=?", (study_id,))
            cur.execute("DELETE FROM study_attrs WHERE study_id=?", (study_id,))
            cur.execute("DELETE FROM study_revisions WHERE study_id=?", (study_id,))
            cur.execute("DELETE FROM studies WHERE study_id=?", (study_id,))
        self._drop_intermediate_store(study_id)
        self._drop_event_log(study_id)

    @_retry
    def get_study_id_from_name(self, study_name: str) -> int:
        cur = self._conn().execute(
            "SELECT study_id FROM studies WHERE study_name=?", (study_name,)
        )
        row = cur.fetchone()
        if row is None:
            raise StudyNotFoundError(study_name)
        return row[0]

    @_retry
    def get_study_name_from_id(self, study_id: int) -> str:
        cur = self._conn().execute(
            "SELECT study_name FROM studies WHERE study_id=?", (study_id,)
        )
        row = cur.fetchone()
        if row is None:
            raise StudyNotFoundError(study_id)
        return row[0]

    @_retry
    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        cur = self._conn().execute(
            "SELECT directions FROM studies WHERE study_id=?", (study_id,)
        )
        row = cur.fetchone()
        if row is None:
            raise StudyNotFoundError(study_id)
        return [StudyDirection(d) for d in json.loads(row[0])]

    @_retry
    def get_all_studies(self) -> list[StudySummary]:
        cur = self._conn().execute("SELECT study_id, study_name, directions FROM studies")
        out = []
        for sid, name, dirs in cur.fetchall():
            n = self._conn().execute(
                "SELECT COUNT(*) FROM trials WHERE study_id=?", (sid,)
            ).fetchone()[0]
            out.append(
                StudySummary(
                    sid, name, [StudyDirection(d) for d in json.loads(dirs)], n,
                    self.get_study_user_attrs(sid), self.get_study_system_attrs(sid),
                )
            )
        return out

    def _set_study_attr(self, study_id: int, key: str, value: Any, is_system: int) -> None:
        with self._tx() as cur:
            cur.execute(
                "INSERT OR REPLACE INTO study_attrs (study_id, is_system, key, value_json)"
                " VALUES (?, ?, ?, ?)",
                (study_id, is_system, key, json.dumps(value)),
            )

    def _get_study_attrs(self, study_id: int, is_system: int) -> dict[str, Any]:
        cur = self._conn().execute(
            "SELECT key, value_json FROM study_attrs WHERE study_id=? AND is_system=?",
            (study_id, is_system),
        )
        return {k: json.loads(v) for k, v in cur.fetchall()}

    set_study_user_attr = _retry(lambda self, sid, k, v: self._set_study_attr(sid, k, v, 0))
    set_study_system_attr = _retry(lambda self, sid, k, v: self._set_study_attr(sid, k, v, 1))
    get_study_user_attrs = _retry(lambda self, sid: self._get_study_attrs(sid, 0))
    get_study_system_attrs = _retry(lambda self, sid: self._get_study_attrs(sid, 1))

    # -- trial -----------------------------------------------------------------

    @_retry
    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        with self._tx() as cur:
            cur.execute("SELECT COUNT(*) FROM studies WHERE study_id=?", (study_id,))
            if cur.fetchone()[0] == 0:
                raise StudyNotFoundError(study_id)
            cur.execute(
                "SELECT COALESCE(MAX(number), -1) + 1 FROM trials WHERE study_id=?",
                (study_id,),
            )
            number = cur.fetchone()[0]
            t = template_trial
            state = t.state if t is not None else TrialState.RUNNING
            values = json.dumps(t.values) if t is not None and t.values else None
            start = self._dt(t.datetime_start) if t is not None and t.datetime_start else (
                None if state == TrialState.WAITING else self._dt(self._now())
            )
            cur.execute(
                "INSERT INTO trials (study_id, number, state, values_json, datetime_start)"
                " VALUES (?, ?, ?, ?, ?)",
                (study_id, number, int(state), values, start),
            )
            tid = cur.lastrowid
            if t is not None:
                for name, dist in t.distributions.items():
                    cur.execute(
                        "INSERT INTO trial_params VALUES (?, ?, ?, ?)",
                        (tid, name, dist.to_internal_repr(t.params[name]),
                         distribution_to_json(dist)),
                    )
                for step, v in t.intermediate_values.items():
                    cur.execute(
                        "INSERT INTO trial_intermediate_values VALUES (?, ?, ?)",
                        (tid, step, v),
                    )
                for k, v in t.user_attrs.items():
                    cur.execute("INSERT INTO trial_attrs VALUES (?, 0, ?, ?)", (tid, k, json.dumps(v)))
                for k, v in t.system_attrs.items():
                    cur.execute("INSERT INTO trial_attrs VALUES (?, 1, ?, ?)", (tid, k, json.dumps(v)))
            self._bump_revision(cur, study_id)
        # after commit: the event log takes its own leaf lock
        self._record_event(study_id, _telemetry.EV_CREATED, number)
        return tid

    @staticmethod
    def _bump_revision(cur: sqlite3.Cursor, study_id: int) -> None:
        cur.execute(
            "INSERT INTO study_revisions VALUES (?, 1)"
            " ON CONFLICT(study_id) DO UPDATE SET revision = revision + 1",
            (study_id,),
        )

    @staticmethod
    def _bump_revision_for_trial(cur: sqlite3.Cursor, trial_id: int) -> None:
        cur.execute("SELECT study_id FROM trials WHERE trial_id=?", (trial_id,))
        row = cur.fetchone()
        if row is not None:
            SQLiteStorage._bump_revision(cur, row[0])

    @_retry
    def set_trial_param(
        self, trial_id: int, param_name: str, param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        with self._tx() as cur:
            state = self._trial_state(cur, trial_id)
            if state.is_finished():
                raise RuntimeError(f"trial {trial_id} is already finished")
            cur.execute(
                "SELECT distribution_json FROM trial_params WHERE trial_id=? AND param_name=?",
                (trial_id, param_name),
            )
            row = cur.fetchone()
            if row is not None:
                check_distribution_compatibility(json_to_distribution(row[0]), distribution)
            cur.execute(
                "INSERT OR REPLACE INTO trial_params VALUES (?, ?, ?, ?)",
                (trial_id, param_name, float(param_value_internal), distribution_to_json(distribution)),
            )
            self._bump_revision_for_trial(cur, trial_id)

    @_retry
    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        with self._tx() as cur:
            old = self._trial_state(cur, trial_id)
            if state == TrialState.RUNNING and old != TrialState.WAITING:
                return False
            sets = ["state=?"]
            args: list[Any] = [int(state)]
            if values is not None:
                sets.append("values_json=?")
                args.append(json.dumps([float(v) for v in values]))
            if state == TrialState.RUNNING:
                sets.append("datetime_start=?")
                args.append(self._dt(self._now()))
            if state.is_finished():
                sets.append("datetime_complete=?")
                args.append(self._dt(self._now()))
            args.append(trial_id)
            cur.execute(f"UPDATE trials SET {', '.join(sets)} WHERE trial_id=?", args)
            if state.is_finished():
                cur.execute("DELETE FROM trial_heartbeats WHERE trial_id=?", (trial_id,))
            self._bump_revision_for_trial(cur, trial_id)
            cur.execute(
                "SELECT study_id, number FROM trials WHERE trial_id=?", (trial_id,)
            )
            row = cur.fetchone()
        if row is not None:
            self._record_state_event(row[0], state, row[1])
        return True

    @_retry
    def set_trial_intermediate_value(self, trial_id: int, step: int, intermediate_value: float) -> None:
        with self._tx() as cur:
            if self._trial_state(cur, trial_id).is_finished():
                raise RuntimeError(f"trial {trial_id} is already finished")
            cur.execute(
                "INSERT OR REPLACE INTO trial_intermediate_values VALUES (?, ?, ?)",
                (trial_id, int(step), float(intermediate_value)),
            )
            self._bump_revision_for_trial(cur, trial_id)
            cur.execute(
                "SELECT study_id, number FROM trials WHERE trial_id=?", (trial_id,)
            )
            row = cur.fetchone()
        # after commit: stores lock store-first
        self._note_iv_dirty(trial_id, row[0] if row is not None else None)
        if row is not None:
            self._record_event(row[0], _telemetry.EV_REPORTED, row[1], step=int(step))

    def _set_trial_attr(self, trial_id: int, key: str, value: Any, is_system: int) -> None:
        with self._tx() as cur:
            self._trial_state(cur, trial_id)  # existence check
            cur.execute(
                "INSERT OR REPLACE INTO trial_attrs VALUES (?, ?, ?, ?)",
                (trial_id, is_system, key, json.dumps(value)),
            )
            self._bump_revision_for_trial(cur, trial_id)

    set_trial_user_attr = _retry(lambda self, tid, k, v: self._set_trial_attr(tid, k, v, 0))
    set_trial_system_attr = _retry(lambda self, tid, k, v: self._set_trial_attr(tid, k, v, 1))

    @_retry
    def get_trial(self, trial_id: int) -> FrozenTrial:
        conn = self._conn()
        cur = conn.execute(
            "SELECT study_id, number, state, values_json, datetime_start, datetime_complete"
            " FROM trials WHERE trial_id=?",
            (trial_id,),
        )
        row = cur.fetchone()
        if row is None:
            raise TrialNotFoundError(trial_id)
        return self._row_to_trial(trial_id, row)

    def _row_to_trial(self, trial_id: int, row) -> FrozenTrial:
        conn = self._conn()
        _, number, state, values_json, start, complete = row
        params, dists = {}, {}
        for name, val, dist_json in conn.execute(
            "SELECT param_name, param_value, distribution_json FROM trial_params WHERE trial_id=?",
            (trial_id,),
        ):
            dist = json_to_distribution(dist_json)
            params[name] = dist.to_external_repr(val)
            dists[name] = dist
        # SQLite stores a NaN as NULL: a NaN report reads back as the NaN it
        # was, which the pruners rank (a None would break their comparisons)
        ivs = {
            s: math.nan if v is None else v for s, v in conn.execute(
                "SELECT step, value FROM trial_intermediate_values WHERE trial_id=?", (trial_id,)
            )
        }
        uattrs, sattrs = {}, {}
        for is_sys, k, v in conn.execute(
            "SELECT is_system, key, value_json FROM trial_attrs WHERE trial_id=?", (trial_id,)
        ):
            (sattrs if is_sys else uattrs)[k] = json.loads(v)
        return FrozenTrial(
            number=number,
            state=TrialState(state),
            values=json.loads(values_json) if values_json else None,
            params=params,
            distributions=dists,
            intermediate_values=ivs,
            user_attrs=uattrs,
            system_attrs=sattrs,
            trial_id=trial_id,
            datetime_start=self._parse_dt(start),
            datetime_complete=self._parse_dt(complete),
        )

    @_retry
    def get_all_trials(
        self, study_id: int, deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        conn = self._conn()
        q = (
            "SELECT trial_id, study_id, number, state, values_json, datetime_start,"
            " datetime_complete FROM trials WHERE study_id=?"
        )
        args: list[Any] = [study_id]
        if since is not None:
            q += " AND number >= ?"
            args.append(int(since))
        if states is not None:
            q += f" AND state IN ({','.join('?' * len(states))})"
            args += [int(s) for s in states]
        q += " ORDER BY number"
        out = []
        for row in conn.execute(q, args).fetchall():
            out.append(self._row_to_trial(row[0], row[1:]))
        return out

    @_retry
    def get_n_trials(self, study_id: int, states: tuple[TrialState, ...] | None = None) -> int:
        q = "SELECT COUNT(*) FROM trials WHERE study_id=?"
        args: list[Any] = [study_id]
        if states is not None:
            q += f" AND state IN ({','.join('?' * len(states))})"
            args += [int(s) for s in states]
        return self._conn().execute(q, args).fetchone()[0]

    @_retry
    def get_trials_revision(self, study_id: int) -> int:
        cur = self._conn().execute(
            "SELECT revision FROM study_revisions WHERE study_id=?", (study_id,)
        )
        row = cur.fetchone()
        if row is not None:
            return row[0]
        if self._conn().execute(
            "SELECT COUNT(*) FROM studies WHERE study_id=?", (study_id,)
        ).fetchone()[0] == 0:
            raise StudyNotFoundError(study_id)
        return 0

    @staticmethod
    def _trial_state(cur: sqlite3.Cursor, trial_id: int) -> TrialState:
        cur.execute("SELECT state FROM trials WHERE trial_id=?", (trial_id,))
        row = cur.fetchone()
        if row is None:
            raise TrialNotFoundError(trial_id)
        return TrialState(row[0])

    # -- heartbeat ----------------------------------------------------------------

    @_retry
    def record_heartbeat(self, trial_id: int) -> None:
        with self._tx() as cur:
            cur.execute(
                "INSERT OR REPLACE INTO trial_heartbeats VALUES (?, ?)",
                (trial_id, time.time()),
            )

    @_retry
    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        cutoff = time.time() - grace_seconds
        cur = self._conn().execute(
            "SELECT t.trial_id FROM trials t JOIN trial_heartbeats h"
            " ON t.trial_id = h.trial_id"
            " WHERE t.study_id=? AND t.state=? AND h.heartbeat_at < ?",
            (study_id, int(TrialState.RUNNING), cutoff),
        )
        return [r[0] for r in cur.fetchall()]

    # -- misc -----------------------------------------------------------------------

    @staticmethod
    def _dt(dt: datetime.datetime) -> str:
        return dt.isoformat()

    @staticmethod
    def _parse_dt(s: str | None) -> datetime.datetime | None:
        return datetime.datetime.fromisoformat(s) if s else None

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

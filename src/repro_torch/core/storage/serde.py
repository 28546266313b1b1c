"""Wire codecs for the remote storage protocol.

Two codecs share this module:

* **v1 (JSON)** — :func:`pack` / :func:`unpack`.  Everything that crosses the
  ``remote://`` socket is JSON; the handful of rich types in the storage API
  (``FrozenTrial``, ``BaseDistribution``, ``StudySummary``,
  ``TrialState``/``StudyDirection``, ``datetime``) are encoded as tagged
  objects so the decoder can reconstruct them without ambiguity.  Parameter
  *values* need no tagging: the suggest API guarantees external reprs are
  JSON-native (see ``CategoricalDistribution``).

* **v2 (binary)** — :func:`bdumps` / :func:`bloads`.  A msgpack-free tagged
  binary format (one tag byte per value, big-endian ``struct`` scalars,
  length-prefixed strings) whose headline feature is a native ``ndarray``
  tag: dtype + shape header followed by the raw C-order buffer, decoded with
  ``np.frombuffer`` over the received frame — zero copy.  Negotiated per
  connection via the ``hello`` RPC (see ``server.py``); both codecs decode
  to *identical* Python values so a study is bit-identical under either.

The columnar **block builders** (:func:`build_observation_block` /
:func:`build_iv_block`) also live here: they flatten a trial delta into the
dict-of-arrays layout that ``ObservationStore`` / ``IntermediateValueStore``
ingest as a near-memcpy on the client.  Internal (model-space) values are
computed with the exact one-element ``to_internal`` call the client-side
per-trial path uses, so the resulting matrices are bit-identical.
"""

from __future__ import annotations

import datetime
import struct
from typing import Any

import numpy as np

from ..distributions import distribution_to_json, json_to_distribution
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import StudySummary

__all__ = [
    "pack",
    "unpack",
    "bdumps",
    "bjoin",
    "bloads",
    "build_observation_block",
    "build_iv_block",
    "BINARY_MAGIC",
]

_TRIAL = "__frozen_trial__"
_DIST = "__distribution__"
_SUMMARY = "__study_summary__"
_STATE = "__trial_state__"
_DIRECTION = "__study_direction__"
_DATETIME = "__datetime__"


def pack(obj: Any) -> Any:
    """Recursively convert a storage-API value into pure-JSON structures."""
    # enum checks must precede the primitive check: IntEnum instances are ints
    if isinstance(obj, TrialState):
        return {_STATE: int(obj)}
    if isinstance(obj, StudyDirection):
        return {_DIRECTION: int(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, datetime.datetime):
        return {_DATETIME: obj.isoformat()}
    if isinstance(obj, FrozenTrial):
        return {
            _TRIAL: {
                "number": obj.number,
                "state": int(obj.state),
                "values": obj.values,
                # attrs/params may legally hold rich values (e.g. datetimes in
                # user_attrs) -> pack recursively, symmetric with unpack below
                "params": pack(obj.params),
                "distributions": {
                    k: distribution_to_json(d) for k, d in obj.distributions.items()
                },
                "intermediate_values": {str(k): v for k, v in obj.intermediate_values.items()},
                "user_attrs": pack(obj.user_attrs),
                "system_attrs": pack(obj.system_attrs),
                "trial_id": obj.trial_id,
                "datetime_start": pack(obj.datetime_start),
                "datetime_complete": pack(obj.datetime_complete),
            }
        }
    if isinstance(obj, StudySummary):
        return {
            _SUMMARY: {
                "study_id": obj.study_id,
                "study_name": obj.study_name,
                "directions": [int(d) for d in obj.directions],
                "n_trials": obj.n_trials,
                "user_attrs": pack(obj.user_attrs),
                "system_attrs": pack(obj.system_attrs),
            }
        }
    # distributions have no common tag field; detect by duck type
    if hasattr(obj, "_asdict") and hasattr(obj, "to_internal_repr"):
        return {_DIST: distribution_to_json(obj)}
    if isinstance(obj, (list, tuple)):
        return [pack(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): pack(v) for k, v in obj.items()}
    raise TypeError(f"cannot serialize {type(obj).__name__} for the storage protocol")


def unpack(obj: Any) -> Any:
    """Inverse of :func:`pack`."""
    if isinstance(obj, list):
        return [unpack(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    if _STATE in obj:
        return TrialState(obj[_STATE])
    if _DIRECTION in obj:
        return StudyDirection(obj[_DIRECTION])
    if _DATETIME in obj:
        return datetime.datetime.fromisoformat(obj[_DATETIME])
    if _DIST in obj:
        return json_to_distribution(obj[_DIST])
    if _TRIAL in obj:
        d = obj[_TRIAL]
        return FrozenTrial(
            number=d["number"],
            state=TrialState(d["state"]),
            values=d["values"],
            params=unpack(d["params"]),
            distributions={k: json_to_distribution(s) for k, s in d["distributions"].items()},
            intermediate_values={int(k): v for k, v in d["intermediate_values"].items()},
            user_attrs=unpack(d["user_attrs"]),
            system_attrs=unpack(d["system_attrs"]),
            trial_id=d["trial_id"],
            datetime_start=unpack(d["datetime_start"]),
            datetime_complete=unpack(d["datetime_complete"]),
        )
    if _SUMMARY in obj:
        d = obj[_SUMMARY]
        return StudySummary(
            d["study_id"],
            d["study_name"],
            [StudyDirection(x) for x in d["directions"]],
            d["n_trials"],
            unpack(d["user_attrs"]),
            unpack(d["system_attrs"]),
        )
    return {k: unpack(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# Binary codec (wire protocol v2)
# ---------------------------------------------------------------------------

#: first payload byte of every v2 frame, in both directions.  A JSON payload
#: can never start with this byte (0xB2 is not valid leading UTF-8), so a
#: misrouted frame fails loudly instead of decoding to garbage.
BINARY_MAGIC = 0xB2

_B_NONE = 0x00
_B_FALSE = 0x01
_B_TRUE = 0x02
_B_INT = 0x03       # >q
_B_FLOAT = 0x04     # >d
_B_STR = 0x05       # u32 byte length + utf-8
_B_BYTES = 0x06     # u32 length + raw
_B_LIST = 0x07      # u32 count + items
_B_DICT = 0x08      # u32 count + (u32+utf8 key, value) pairs; keys str()-ed
_B_NDARRAY = 0x09   # u8 dtype-str len + ascii dtype + u8 ndim + u32 dims + raw
_B_STATE = 0x0A     # u8 TrialState
_B_DIRECTION = 0x0B  # u8 StudyDirection
_B_DATETIME = 0x0C  # u32+utf8 isoformat (mirrors the v1 tagged encoding)
_B_DIST = 0x0D      # u32+utf8 distribution_to_json
_B_TRIAL = 0x0E     # FrozenTrial, fixed field order (see _benc)
_B_SUMMARY = 0x0F   # StudySummary, fixed field order
_B_BIGINT = 0x10    # u32+ascii decimal; ints outside the i64 range

_S_I64 = struct.Struct(">q")
_S_F64 = struct.Struct(">d")
_S_U32 = struct.Struct(">I")


def _benc_str(s: str, buf: bytearray) -> None:
    b = s.encode("utf-8")
    buf += _S_U32.pack(len(b))
    buf += b


def _benc(obj: Any, buf: bytearray) -> None:
    # exact-type dispatch first (hot path); enum/numpy/subclass stragglers
    # fall through to the isinstance chain below, where enum checks must
    # precede the int fallback (TrialState is an IntEnum)
    t = type(obj)
    if obj is None:
        buf.append(_B_NONE)
    elif t is bool:
        buf.append(_B_TRUE if obj else _B_FALSE)
    elif t is int:
        if -(2**63) <= obj < 2**63:
            buf.append(_B_INT)
            buf += _S_I64.pack(obj)
        else:
            buf.append(_B_BIGINT)
            _benc_str(str(obj), buf)
    elif t is float:
        buf.append(_B_FLOAT)
        buf += _S_F64.pack(obj)
    elif t is str:
        buf.append(_B_STR)
        _benc_str(obj, buf)
    elif t is list or t is tuple:
        buf.append(_B_LIST)
        buf += _S_U32.pack(len(obj))
        for v in obj:
            _benc(v, buf)
    elif t is dict:
        buf.append(_B_DICT)
        buf += _S_U32.pack(len(obj))
        for k, v in obj.items():
            # str(k) mirrors v1's JSON key stringification so both protocols
            # decode to identical dicts
            _benc_str(k if type(k) is str else str(k), buf)
            _benc(v, buf)
    elif t is bytes:
        buf.append(_B_BYTES)
        buf += _S_U32.pack(len(obj))
        buf += obj
    elif isinstance(obj, TrialState):
        buf.append(_B_STATE)
        buf.append(int(obj))
    elif isinstance(obj, StudyDirection):
        buf.append(_B_DIRECTION)
        buf.append(int(obj))
    elif isinstance(obj, datetime.datetime):
        buf.append(_B_DATETIME)
        _benc_str(obj.isoformat(), buf)
    elif isinstance(obj, FrozenTrial):
        buf.append(_B_TRIAL)
        buf += _S_I64.pack(obj.number)
        buf.append(int(obj.state))
        _benc(obj.values, buf)
        _benc(obj.params, buf)
        buf += _S_U32.pack(len(obj.distributions))
        for k, d in obj.distributions.items():
            _benc_str(k, buf)
            _benc_str(distribution_to_json(d), buf)
        buf += _S_U32.pack(len(obj.intermediate_values))
        for s, v in obj.intermediate_values.items():
            buf += _S_I64.pack(int(s))
            _benc(v, buf)
        _benc(obj.user_attrs, buf)
        _benc(obj.system_attrs, buf)
        buf += _S_I64.pack(obj.trial_id)
        _benc(obj.datetime_start, buf)
        _benc(obj.datetime_complete, buf)
    elif isinstance(obj, StudySummary):
        buf.append(_B_SUMMARY)
        buf += _S_I64.pack(obj.study_id)
        _benc_str(obj.study_name, buf)
        buf += _S_U32.pack(len(obj.directions))
        for d in obj.directions:
            buf.append(int(d))
        buf += _S_I64.pack(obj.n_trials)
        _benc(obj.user_attrs, buf)
        _benc(obj.system_attrs, buf)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode("ascii")
        if arr.dtype.hasobject:
            raise TypeError("cannot serialize object-dtype arrays")
        buf.append(_B_NDARRAY)
        buf.append(len(dt))
        buf += dt
        buf.append(arr.ndim)
        for dim in arr.shape:
            buf += _S_U32.pack(dim)
        buf += arr.tobytes()
    elif isinstance(obj, (bool, np.bool_)):
        buf.append(_B_TRUE if obj else _B_FALSE)
    elif isinstance(obj, (int, np.integer)):
        _benc(int(obj), buf)
    elif isinstance(obj, (float, np.floating)):
        buf.append(_B_FLOAT)
        buf += _S_F64.pack(float(obj))
    elif isinstance(obj, str):
        buf.append(_B_STR)
        _benc_str(obj, buf)
    elif hasattr(obj, "_asdict") and hasattr(obj, "to_internal_repr"):
        buf.append(_B_DIST)
        _benc_str(distribution_to_json(obj), buf)
    elif isinstance(obj, (list, tuple)):
        buf.append(_B_LIST)
        buf += _S_U32.pack(len(obj))
        for v in obj:
            _benc(v, buf)
    elif isinstance(obj, dict):
        buf.append(_B_DICT)
        buf += _S_U32.pack(len(obj))
        for k, v in obj.items():
            _benc_str(k if type(k) is str else str(k), buf)
            _benc(v, buf)
    else:
        raise TypeError(
            f"cannot serialize {type(obj).__name__} for the binary storage protocol"
        )


def bdumps(obj: Any) -> bytes:
    """Encode a storage-API value into the v2 binary format (sans magic)."""
    buf = bytearray()
    _benc(obj, buf)
    return bytes(buf)


def _bdec_str(mv: memoryview, off: int) -> tuple[str, int]:
    (n,) = _S_U32.unpack_from(mv, off)
    off += 4
    if off + n > len(mv):
        raise ValueError("truncated string in binary payload")
    return str(mv[off : off + n], "utf-8"), off + n


def _bdec(mv: memoryview, off: int) -> tuple[Any, int]:
    tag = mv[off]
    off += 1
    if tag == _B_NONE:
        return None, off
    if tag == _B_FALSE:
        return False, off
    if tag == _B_TRUE:
        return True, off
    if tag == _B_INT:
        (v,) = _S_I64.unpack_from(mv, off)
        return v, off + 8
    if tag == _B_FLOAT:
        (v,) = _S_F64.unpack_from(mv, off)
        return v, off + 8
    if tag == _B_STR:
        return _bdec_str(mv, off)
    if tag == _B_BIGINT:
        s, off = _bdec_str(mv, off)
        return int(s), off
    if tag == _B_BYTES:
        (n,) = _S_U32.unpack_from(mv, off)
        off += 4
        if off + n > len(mv):
            raise ValueError("truncated bytes in binary payload")
        return bytes(mv[off : off + n]), off + n
    if tag == _B_LIST:
        (n,) = _S_U32.unpack_from(mv, off)
        off += 4
        out = []
        for _ in range(n):
            v, off = _bdec(mv, off)
            out.append(v)
        return out, off
    if tag == _B_DICT:
        (n,) = _S_U32.unpack_from(mv, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _bdec_str(mv, off)
            d[k], off = _bdec(mv, off)
        return d, off
    if tag == _B_NDARRAY:
        dtn = mv[off]
        off += 1
        dt = np.dtype(str(mv[off : off + dtn], "ascii"))
        off += dtn
        ndim = mv[off]
        off += 1
        shape = []
        count = 1
        for _ in range(ndim):
            (dim,) = _S_U32.unpack_from(mv, off)
            off += 4
            shape.append(dim)
            count *= dim
        nbytes = dt.itemsize * count
        if off + nbytes > len(mv):
            raise ValueError("truncated array in binary payload")
        # zero copy: the array is a read-only view over the received frame
        arr = np.frombuffer(mv[off : off + nbytes], dtype=dt).reshape(shape)
        return arr, off + nbytes
    if tag == _B_STATE:
        return TrialState(mv[off]), off + 1
    if tag == _B_DIRECTION:
        return StudyDirection(mv[off]), off + 1
    if tag == _B_DATETIME:
        s, off = _bdec_str(mv, off)
        return datetime.datetime.fromisoformat(s), off
    if tag == _B_DIST:
        s, off = _bdec_str(mv, off)
        return json_to_distribution(s), off
    if tag == _B_TRIAL:
        (number,) = _S_I64.unpack_from(mv, off)
        off += 8
        state = TrialState(mv[off])
        off += 1
        values, off = _bdec(mv, off)
        params, off = _bdec(mv, off)
        (nd,) = _S_U32.unpack_from(mv, off)
        off += 4
        dists = {}
        for _ in range(nd):
            k, off = _bdec_str(mv, off)
            s, off = _bdec_str(mv, off)
            dists[k] = json_to_distribution(s)
        (ni,) = _S_U32.unpack_from(mv, off)
        off += 4
        ivs = {}
        for _ in range(ni):
            (step,) = _S_I64.unpack_from(mv, off)
            off += 8
            ivs[step], off = _bdec(mv, off)
        user_attrs, off = _bdec(mv, off)
        system_attrs, off = _bdec(mv, off)
        (trial_id,) = _S_I64.unpack_from(mv, off)
        off += 8
        dt_start, off = _bdec(mv, off)
        dt_complete, off = _bdec(mv, off)
        return (
            FrozenTrial(
                number=number,
                state=state,
                values=values,
                params=params,
                distributions=dists,
                intermediate_values=ivs,
                user_attrs=user_attrs,
                system_attrs=system_attrs,
                trial_id=trial_id,
                datetime_start=dt_start,
                datetime_complete=dt_complete,
            ),
            off,
        )
    if tag == _B_SUMMARY:
        (study_id,) = _S_I64.unpack_from(mv, off)
        off += 8
        name, off = _bdec_str(mv, off)
        (nd,) = _S_U32.unpack_from(mv, off)
        off += 4
        directions = [StudyDirection(mv[off + i]) for i in range(nd)]
        off += nd
        (n_trials,) = _S_I64.unpack_from(mv, off)
        off += 8
        user_attrs, off = _bdec(mv, off)
        system_attrs, off = _bdec(mv, off)
        return StudySummary(study_id, name, directions, n_trials, user_attrs, system_attrs), off
    raise ValueError(f"bad binary tag 0x{tag:02x}")


def bjoin(blobs: "list[bytes]") -> bytes:
    """Assemble pre-encoded items (each a :func:`bdumps` payload) into one
    encoded list, without re-encoding — the server's batched-response path."""
    return bytes([_B_LIST]) + _S_U32.pack(len(blobs)) + b"".join(blobs)


def bloads(data: "bytes | bytearray | memoryview") -> Any:
    """Inverse of :func:`bdumps`.  Raises ``ValueError``/``struct.error`` on
    malformed input — never crashes past the payload bounds."""
    mv = memoryview(data)
    try:
        obj, off = _bdec(mv, 0)
    except IndexError:
        raise ValueError("truncated binary payload") from None
    if off != len(mv):
        raise ValueError("trailing bytes in binary payload")
    return obj


# ---------------------------------------------------------------------------
# Columnar block builders (shared by server dispatch and tests)
# ---------------------------------------------------------------------------

_GRID_ATTR = "grid_sampler:grid_id"  # mirrors records._GRID_ATTR (wire constant)


def _iv_items(trial) -> list:
    # deepcopy=False on in-process backends hands out live dict refs: a
    # concurrent report can mutate mid-iteration, so snapshot with retry
    # (same policy as IntermediateValueStore._ingest)
    for _ in range(3):
        try:
            return list(trial.intermediate_values.items())
        except RuntimeError:  # pragma: no cover - dict-resize race
            continue
    return list(trial.intermediate_values.items())


def build_observation_block(trials, n_objectives: int) -> dict:
    """Flatten finished trials into the ``ObservationStore`` ingest layout.

    One row per *finished* trial, in input order (the order the client-side
    per-trial path would have appended them).  ``internal`` columns are
    computed with one-element ``to_internal`` calls — the exact arithmetic
    ``ObservationStore._append`` runs — so ingest is bit-identical to the
    per-trial path.  Distributions are interned per parameter by identical
    JSON (``dist_idx`` indexes the ``dists`` side table), which preserves
    bounds drift across trials.
    """
    rows = [t for t in trials if t.state.is_finished()]
    k = len(rows)
    m = int(n_objectives)
    numbers = np.empty(k, dtype=np.int64)
    states = np.empty(k, dtype=np.int8)
    values = np.full(k, np.nan)
    values_len = np.zeros(k, dtype=np.int64)
    values_mat = np.full((k, m), np.nan)
    last_iv = np.full(k, np.nan)
    grid_ids = np.full(k, -1, dtype=np.int64)
    params: dict[str, dict] = {}
    interned: dict[str, dict] = {}
    for i, t in enumerate(rows):
        numbers[i] = t.number
        states[i] = int(t.state)
        vals = t.values or []
        if vals:
            values[i] = vals[0]
        values_len[i] = len(vals)
        if len(vals) == m:
            values_mat[i, :] = vals
        last = t.last_step
        if last is not None:
            last_iv[i] = t.intermediate_values[last]
        gid = t.system_attrs.get(_GRID_ATTR)
        if gid is not None:
            grid_ids[i] = int(gid)
        for name, dist in t.distributions.items():
            ent = params.get(name)
            if ent is None:
                ent = params[name] = {
                    "internal": np.full(k, np.nan),
                    "dist_idx": np.full(k, -1, dtype=np.int64),
                    "dists": [],
                }
                interned[name] = {}
            dj = distribution_to_json(dist)
            idx = interned[name].get(dj)
            if idx is None:
                idx = len(ent["dists"])
                ent["dists"].append(dj)
                interned[name][dj] = idx
            ent["dist_idx"][i] = idx
            # one-element to_internal: bit-identical to the client-side path
            ent["internal"][i] = float(dist.to_internal([t.params[name]])[0])
    return {
        "n": k,
        "n_objectives": m,
        "numbers": numbers,
        "states": states,
        "values": values,
        "values_len": values_len,
        "values_mat": values_mat,
        "last_iv": last_iv,
        "grid_ids": grid_ids,
        "params": params,
    }


_IV_VEC_PREFIX = "iv_vec:"  # mirrors frozen.IV_VEC_PREFIX (wire constant)


def _iv_vec_items(trial) -> list:
    # same live-dict snapshot policy as _iv_items, over system attrs
    for _ in range(3):
        try:
            return [
                (int(k[len(_IV_VEC_PREFIX):]), [float(x) for x in v])
                for k, v in trial.system_attrs.items()
                if isinstance(k, str) and k.startswith(_IV_VEC_PREFIX)
            ]
        except (RuntimeError, TypeError, ValueError):  # pragma: no cover
            continue
    return []


def build_iv_block(trials) -> dict:
    """Flatten a trial delta into the ``IntermediateValueStore`` ingest
    layout: CSR (``rowptr``/``steps``/``vals``) over *all* trials in input
    order — RUNNING rows included, since the IV store tracks live trials.

    Per-objective vector reports (``iv_vec:<step>`` system attrs) travel as
    a second flat CSR (``vec_numbers``/``vec_steps``/``vec_ptr``/``vec_vals``)
    appended **only when at least one trial carries vectors** — scalar
    studies stay byte-identical on the wire."""
    k = len(trials)
    numbers = np.empty(k, dtype=np.int64)
    states = np.empty(k, dtype=np.int8)
    trial_ids = np.empty(k, dtype=np.int64)
    rowptr = np.zeros(k + 1, dtype=np.int64)
    steps: list[int] = []
    vals: list[float] = []
    vec_numbers: list[int] = []
    vec_steps: list[int] = []
    vec_ptr: list[int] = [0]
    vec_vals: list[float] = []
    for i, t in enumerate(trials):
        numbers[i] = t.number
        states[i] = int(t.state)
        trial_ids[i] = t.trial_id
        items = _iv_items(t)
        rowptr[i + 1] = rowptr[i] + len(items)
        for s, v in items:
            steps.append(int(s))
            vals.append(v)
        for s, vec in _iv_vec_items(t):
            vec_numbers.append(t.number)
            vec_steps.append(s)
            vec_vals.extend(vec)
            vec_ptr.append(len(vec_vals))
    block = {
        "n": k,
        "numbers": numbers,
        "states": states,
        "trial_ids": trial_ids,
        "rowptr": rowptr,
        "steps": np.asarray(steps, dtype=np.int64),
        "vals": np.asarray(vals, dtype=np.float64),
    }
    if vec_numbers:
        block["vec_numbers"] = np.asarray(vec_numbers, dtype=np.int64)
        block["vec_steps"] = np.asarray(vec_steps, dtype=np.int64)
        block["vec_ptr"] = np.asarray(vec_ptr, dtype=np.int64)
        block["vec_vals"] = np.asarray(vec_vals, dtype=np.float64)
    return block

"""Networked storage server — the piece that turns "N processes on one box"
into "N workers on a fleet" (paper §4's scalable deployment criterion).

A :class:`StorageServer` wraps *any* :class:`BaseStorage` backend and exposes
it over TCP to :class:`~repro_torch.core.storage.client.RemoteStorage` clients.

Protocol
--------
Every frame is a 4-byte big-endian payload length followed by the payload.
Two payload encodings share that framing, negotiated per connection:

* **v1 (JSON, default)** — UTF-8 JSON-RPC.  A request is ``{"id", "method",
  "params"}`` (params encoded with :mod:`.serde`); the response is ``{"id",
  "ok", "result"}`` or ``{"id", "ok": false, "error": {"type", "message"}}``.
  A frame may carry a *list* of requests (a batch); the server executes them
  in order and answers with a list of responses in the same frame — one
  round trip for a whole write-behind flush.

* **v2 (binary)** — negotiated via a ``hello`` RPC (sent as JSON; once the
  server acknowledges ``protocol: 2`` both directions switch).  Payloads are
  one ``0xB2`` magic byte followed by the tagged binary encoding of the same
  request/response dicts (:func:`.serde.bdumps`), whose native ``ndarray``
  tag lets the hot RPCs — ``get_all_trials(since=)`` deltas, batched
  ``create_new_trials``, and the columnar ``get_observation_block`` /
  ``get_iv_block`` snapshots — ship raw numpy buffers instead of JSON trial
  dicts.  Legacy JSON clients never send ``hello`` and keep working
  unchanged; a v2 client talking to a JSON-only server falls back to v1 on
  the hello error.

Concurrency: a single-threaded non-blocking event loop (``selectors``
reactor) with per-connection read/write buffers — no thread per connection,
so a 1k-worker storm costs the server zero GIL thrashing.  Atomicity of each
call (e.g. the WAITING->RUNNING compare-and-set in
``set_trial_state_values``) is delegated to the wrapped backend; since all
dispatch happens on the reactor thread, calls are additionally serialized at
the server.  A connection that violates the protocol (oversized length,
garbage payload, mid-frame stall) is dropped in isolation — the loop and
every other connection keep serving.  Graceful shutdown via
:meth:`StorageServer.stop` — pending responses are flushed, then sockets
close.

Security: ``auth_token`` arms the shared-secret first-frame handshake;
``auth_tokens`` adds *scoped* tokens (read-only and/or study-id allowlists)
whose violations surface as ``PermissionError``.  ``tls_cert``/``tls_key``
wrap the listener in TLS (clients connect via ``remote+tls://``).

Fault tolerance (see DESIGN.md "Cluster"): ``journal=True`` keeps a
replayable in-memory op journal of every write dispatch; a second server
started with ``replicate_from=<url>`` subscribes to that journal over the
ordinary wire protocol (``subscribe_ops``), replays each op into its own
backend, and acks the applied sequence number.  With
``sync_replication=True`` the primary *holds* a write's response until the
replica has acked the op — so any client-visible ack implies replica
durability, the invariant the chaos tests pin.  ``promote()`` turns a
replica into a primary under a bumped epoch; clients validate role + epoch
at connect time and refuse stale or unpromoted nodes.  A deterministic
:class:`~repro_torch.core.storage.chaos.FaultInjector` can be attached to drop /
delay / black-hole frames or connections for chaos testing.
"""

from __future__ import annotations

import heapq
import hmac
import json
import os
import selectors
import socket
import ssl
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Any

from .. import telemetry
from ..exceptions import StorageUnavailableError
from ..frozen import TrialState
from .base import BaseStorage, get_trials_since
from .serde import BINARY_MAGIC, bdumps, bjoin, bloads, pack, unpack

__all__ = [
    "StorageServer",
    "OpJournal",
    "send_frame",
    "recv_frame",
    "MAX_FRAME_BYTES",
]

MAX_FRAME_BYTES = 64 * 1024 * 1024  # sanity cap on one frame
MID_FRAME_STALL_SECONDS = 30.0  # max time a peer may stall between bytes of one frame

# The RPC surface: exactly the BaseStorage API (plus ping for liveness).
_METHODS = frozenset(
    {
        "create_new_study",
        "delete_study",
        "get_study_id_from_name",
        "get_study_name_from_id",
        "get_study_directions",
        "get_all_studies",
        "set_study_user_attr",
        "set_study_system_attr",
        "get_study_user_attrs",
        "get_study_system_attrs",
        "create_new_trial",
        "create_new_trials",
        "set_trial_param",
        "set_trial_state_values",
        "set_trial_intermediate_value",
        "report_and_prune",
        "set_trial_user_attr",
        "set_trial_system_attr",
        "get_trial",
        "get_all_trials",
        "get_n_trials",
        "get_trial_id_from_study_and_number",
        "record_heartbeat",
        "get_stale_trial_ids",
        "fail_stale_trials",
        "reclaim_stale_trials",
        "get_trials_revision",
        "get_trial_events",
        "get_observation_block",
        "get_iv_block",
    }
)

# scope enforcement tables: which methods mutate, and how each method names
# the study it touches (first param is a study_id unless listed here)
_WRITE_METHODS = frozenset(
    {
        "create_new_study",
        "delete_study",
        "set_study_user_attr",
        "set_study_system_attr",
        "create_new_trial",
        "create_new_trials",
        "set_trial_param",
        "set_trial_state_values",
        "set_trial_intermediate_value",
        "report_and_prune",
        "set_trial_user_attr",
        "set_trial_system_attr",
        "record_heartbeat",
        "fail_stale_trials",
        "reclaim_stale_trials",
    }
)
_TRIAL_SCOPED = frozenset(
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
# not addressable by one study id — denied outright for study-scoped tokens
_GLOBAL_SCOPED = frozenset({"create_new_study", "get_all_studies"})

# binary-only RPCs: their responses are raw-array blocks that have no JSON
# encoding; v1 clients get a typed NotImplementedError and fall back
_V2_ONLY = frozenset({"get_observation_block", "get_iv_block"})

# methods whose *retransmit* after a torn connection must not re-execute: the
# client stamps them with an ``op`` id, the server remembers the last
# _DEDUP_WINDOW results and answers a replayed frame from memory
_DEDUPED = frozenset(
    {
        "create_new_study",
        "create_new_trial",
        "create_new_trials",
        "set_trial_state_values",
        "report_and_prune",
    }
)
_DEDUP_WINDOW = 8192

# replication stream: ops per frame when pushing a backlog to a new subscriber
_OP_BACKLOG_CHUNK = 500


class OpJournal:
    """Replayable log of every write a server executed, in dispatch order.

    Each entry is ``(seq, op_id, method, params)`` where ``seq`` is the
    entry's index (the log sequence number — dense, starting at 0) and
    ``op_id`` the client's idempotency token (or None).  A replica replays
    entries in order into an empty backend of the same type; because every
    backend assigns study/trial ids deterministically (next-id counters,
    ``number == len(trials)``), the replica converges to bit-identical ids.

    Thread-safety: appends come from the primary's reactor thread, or from a
    replica's tail thread; reads (``since``) from the reactor — one lock.
    """

    __slots__ = ("_lock", "_ops")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ops: list[tuple[int, "str | None", str, list]] = []

    @property
    def end_seq(self) -> int:
        with self._lock:
            return len(self._ops)

    def append(self, method: str, params: list, op_id: "str | None" = None) -> tuple:
        with self._lock:
            ent = (len(self._ops), op_id, method, params)
            self._ops.append(ent)
            return ent

    def append_at(self, seq: int, op_id: "str | None", method: str, params: list) -> None:
        """Replica-side append that preserves the primary's numbering.  A gap
        means the subscription missed ops — unrecoverable, so it raises."""
        with self._lock:
            if seq != len(self._ops):
                raise ValueError(
                    f"op journal gap: expected seq {len(self._ops)}, got {seq}"
                )
            self._ops.append((seq, op_id, method, params))

    def since(self, seq: int) -> list[tuple]:
        with self._lock:
            return list(self._ops[max(0, seq):])


# -- blocking frame helpers (used by the client; the server is non-blocking) --


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes | None:
    """Read one length-prefixed frame; ``None`` on clean EOF.

    A ``socket.timeout`` escapes only while *idle* (no byte of the frame seen
    yet) — once a frame has started, reads are retried so a slow peer cannot
    cause a torn frame, but a peer that stalls longer than
    ``MID_FRAME_STALL_SECONDS`` without sending a single byte raises
    ``ConnectionError`` instead of hanging the caller forever.
    """
    header = _recv_exact(sock, 4, allow_idle_timeout=True)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {length} bytes exceeds cap {MAX_FRAME_BYTES}")
    body = _recv_exact(sock, length, allow_idle_timeout=False)
    if body is None:
        raise ConnectionError("connection closed mid-frame")
    return body


def _recv_exact(sock: socket.socket, n: int, allow_idle_timeout: bool) -> bytes | None:
    buf = b""
    stall_deadline: float | None = None
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if allow_idle_timeout and not buf:
                raise
            now = time.monotonic()
            if stall_deadline is None:
                stall_deadline = now + MID_FRAME_STALL_SECONDS
            elif now >= stall_deadline:
                raise ConnectionError(
                    f"peer stalled mid-frame for over {MID_FRAME_STALL_SECONDS}s"
                ) from None
            continue  # mid-frame: give the peer a bounded grace period
        stall_deadline = None  # any progress resets the stall clock
        if not chunk:
            if buf:
                raise ConnectionError("connection closed mid-frame")
            return None
        buf += chunk
    return buf


# -- auth scopes --------------------------------------------------------------


class _Scope:
    """Capabilities of one auth token: ``readonly`` blocks writes,
    ``studies`` (a frozenset of study ids, or None = all) bounds which
    studies the token may touch."""

    __slots__ = ("readonly", "studies")

    def __init__(self, readonly: bool = False, studies: "frozenset[int] | None" = None):
        self.readonly = readonly
        self.studies = studies

    @property
    def unrestricted(self) -> bool:
        return not self.readonly and self.studies is None


_FULL_SCOPE = _Scope()


def _normalize_tokens(auth_token, auth_tokens) -> list[tuple[str, _Scope]]:
    scopes: list[tuple[str, _Scope]] = []
    if auth_token is not None:
        scopes.append((auth_token, _FULL_SCOPE))
    for ent in auth_tokens or []:
        if isinstance(ent, str):
            scopes.append((ent, _FULL_SCOPE))
            continue
        studies = ent.get("studies")
        scopes.append(
            (
                ent["token"],
                _Scope(
                    readonly=bool(ent.get("readonly", False)),
                    studies=(
                        frozenset(int(s) for s in studies) if studies is not None else None
                    ),
                ),
            )
        )
    return scopes


# -- reactor ------------------------------------------------------------------


class _Drop(Exception):
    """Internal: close this connection (protocol violation or dead peer)."""


class _Conn:
    __slots__ = (
        "sock",
        "peer",
        "inbuf",
        "outbuf",
        "authed",
        "scope",
        "proto",
        "specs",
        "closing",
        "handshaking",
        "stall_deadline",
        "mask",
        "closed",
        "subscriber",
    )

    def __init__(self, sock, peer: str, authed: bool, handshaking: bool):
        self.sock = sock
        self.peer = peer
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.authed = authed
        self.scope: "_Scope | None" = _FULL_SCOPE if authed else None
        self.proto = 1
        # per-connection interned pruner specs (client sends each spec once
        # as __spec_def__, then short __spec_ref__ frames; see client.py)
        self.specs: dict[int, dict] = {}
        self.closing = False  # reply flushed, then close (auth rejection)
        self.handshaking = handshaking  # TLS handshake in progress
        self.stall_deadline: "float | None" = (
            time.monotonic() + MID_FRAME_STALL_SECONDS if handshaking else None
        )
        self.mask = selectors.EVENT_READ
        self.closed = False
        self.subscriber = False  # receives the replication op stream


class _RPCServer:
    """The selectors-based reactor + dispatcher behind :class:`StorageServer`."""

    def __init__(
        self,
        addr: tuple[str, int],
        storage: BaseStorage,
        auth_token: "str | None" = None,
        auth_tokens: "list | None" = None,
        ssl_context: "ssl.SSLContext | None" = None,
        max_protocol: int = 2,
        journal: "OpJournal | None" = None,
        role: str = "primary",
        epoch: int = 1,
        sync_replication: bool = False,
        fault_injector: Any = None,
        reclaim_grace: "float | None" = None,
        reclaim_requeue: bool = False,
        reclaim_interval: float = 1.0,
    ):
        self.storage = storage
        self._scopes = _normalize_tokens(auth_token, auth_tokens)
        self.auth_required = bool(self._scopes)
        self.ssl_context = ssl_context
        self.max_protocol = max_protocol
        self.stopping = threading.Event()
        # -- cluster state ----------------------------------------------------
        self._journal = journal
        self.role = role  # "primary" accepts writes; "replica" refuses them
        self.epoch = int(epoch)
        self.sync_replication = sync_replication
        self.fault_injector = fault_injector
        self._tail_handle: Any = None  # set by StorageServer on replicas
        self._subscribers: set[_Conn] = set()
        self._acked_seq = 0  # highest journal seq a subscriber confirmed applied
        self._pending_acks: "deque[tuple[int, _Conn, bytes]]" = deque()
        self._dedup: "OrderedDict[str, Any]" = OrderedDict()
        self._dedup_lock = threading.Lock()
        self._delayed: list[tuple[float, int, _Conn, bytes]] = []  # fault-injected
        self._delay_counter = 0
        self._reclaim_grace = reclaim_grace
        self._reclaim_requeue = reclaim_requeue
        self._reclaim_interval = reclaim_interval
        self._last_reclaim = time.monotonic()
        self._kill = threading.Event()  # hard-stop: exit without flushing
        # always-on, server-owned registry: get_server_metrics must work
        # without globally enabling client-side telemetry in this process
        self.metrics = telemetry.MetricsRegistry(enabled=True)
        self.started_at = time.time()
        # trial_id -> study_id, maintained only when a study-scoped token
        # exists (enforcement needs it; unscoped servers skip the memory)
        self._track_trials = any(sc.studies is not None for _, sc in self._scopes)
        self._trial_study: dict[int, int] = {}

        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(addr)
        listener.listen(128)
        listener.setblocking(False)
        self._listener = listener
        self.server_address = listener.getsockname()
        self._sel = selectors.DefaultSelector()
        self._conns: set[_Conn] = set()
        self._last_sweep = time.monotonic()
        self._closed = False

    # -- event loop -----------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.1) -> None:
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        try:
            while not self.stopping.is_set():
                if self._kill.is_set():
                    break  # simulated crash: abandon everything in-flight
                for key, mask in self._sel.select(poll_interval):
                    if key.data is None:
                        self._accept()
                    else:
                        conn: _Conn = key.data
                        try:
                            self._service(conn, mask)
                        except _Drop:
                            self._close_conn(conn)
                        except Exception:
                            # one connection's failure must never kill the
                            # loop: drop it, keep serving everyone else
                            self.metrics.counter("server.protocol_errors").inc()
                            self._close_conn(conn)
                now = time.monotonic()
                if self._delayed and self._delayed[0][0] <= now:
                    self._flush_delayed(now)
                if now - self._last_sweep >= 1.0:
                    self._last_sweep = now
                    self._sweep_stalled(now)
                if (
                    self._reclaim_grace is not None
                    and self.role == "primary"
                    and now - self._last_reclaim >= self._reclaim_interval
                ):
                    self._last_reclaim = now
                    self._run_reclaim()
        finally:
            self.close(flush=not self._kill.is_set())

    def _flush_delayed(self, now: float) -> None:
        """Release fault-injector-delayed responses whose hold expired."""
        while self._delayed and self._delayed[0][0] <= now:
            _, _, conn, body = heapq.heappop(self._delayed)
            if not conn.closed:
                try:
                    self._send(conn, body)
                except _Drop:
                    self._close_conn(conn)

    def _run_reclaim(self) -> None:
        """Stale-RUNNING sweep: trials whose worker stopped heartbeating for
        ``reclaim_grace`` seconds are FAILed (or requeued as WAITING).  Runs
        on the reactor thread so the resulting state writes are journaled and
        streamed to replicas like any client write."""
        try:
            summaries = self.storage.get_all_studies()
        except Exception:
            return
        target = TrialState.WAITING if self._reclaim_requeue else TrialState.FAIL
        for s in summaries:
            try:
                tids = self.storage.reclaim_stale_trials(
                    s.study_id, self._reclaim_grace, requeue=self._reclaim_requeue
                )
            except Exception:
                continue
            if not tids:
                continue
            self.metrics.counter("server.reclaimed_trials").inc(len(tids))
            if self._journal is not None:
                ents = [
                    self._journal.append("set_trial_state_values", [tid, target, None])
                    for tid in tids
                ]
                self._stream_ops(ents)

    def close(self, flush: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns):
            if flush and conn.outbuf and not conn.handshaking and not conn.closed:
                # best-effort flush of pending responses on graceful shutdown
                try:
                    conn.sock.setblocking(True)
                    conn.sock.settimeout(1.0)
                    conn.sock.sendall(bytes(conn.outbuf))
                except Exception:
                    pass
            self._close_conn(conn)
        try:
            self._sel.close()
        except Exception:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            fi = self.fault_injector
            if fi is not None and fi.on_accept():
                self.metrics.counter("server.faults.dropped_connects").inc()
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            handshaking = False
            if self.ssl_context is not None:
                try:
                    sock = self.ssl_context.wrap_socket(
                        sock, server_side=True, do_handshake_on_connect=False
                    )
                except (ssl.SSLError, OSError):
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
                handshaking = True
            conn = _Conn(
                sock, "%s:%s" % addr[:2], authed=not self.auth_required,
                handshaking=handshaking,
            )
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, KeyError, OSError):
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            self._conns.add(conn)
            self.metrics.gauge("server.active_connections").add(1)

    def _service(self, conn: _Conn, mask: int) -> None:
        if conn.closed:
            return
        if conn.handshaking:
            self._tls_handshake(conn)
            return
        if mask & selectors.EVENT_READ:
            self._read(conn)
        if not conn.closed and (mask & selectors.EVENT_WRITE):
            self._write(conn)

    def _tls_handshake(self, conn: _Conn) -> None:
        try:
            conn.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._set_mask(conn, selectors.EVENT_READ)
            return
        except ssl.SSLWantWriteError:
            self._set_mask(conn, selectors.EVENT_WRITE)
            return
        except (ssl.SSLError, OSError):
            raise _Drop from None
        conn.handshaking = False
        conn.stall_deadline = None
        self._set_mask(conn, selectors.EVENT_READ)
        # app data may have arrived piggybacked on the final handshake flight
        self._read(conn)

    def _read(self, conn: _Conn) -> None:
        while True:
            try:
                chunk = conn.sock.recv(1 << 16)
            except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                break
            except (BlockingIOError, InterruptedError):
                break
            except (ConnectionError, OSError, ssl.SSLError):
                raise _Drop from None
            if not chunk:
                raise _Drop  # EOF
            conn.inbuf += chunk
            conn.stall_deadline = None  # progress resets the stall clock
            if len(conn.inbuf) > MAX_FRAME_BYTES + 4:
                break  # let frame parsing catch up before buffering more
        self._process_inbuf(conn)

    def _process_inbuf(self, conn: _Conn) -> None:
        inbuf = conn.inbuf
        while not conn.closed and not conn.closing:
            if len(inbuf) < 4:
                break
            length = int.from_bytes(inbuf[:4], "big")
            if length > MAX_FRAME_BYTES:
                # oversized length header: unrecoverable framing state
                self.metrics.counter("server.protocol_errors").inc()
                raise _Drop
            if len(inbuf) < 4 + length:
                break
            payload = bytes(memoryview(inbuf)[4 : 4 + length])
            del inbuf[: 4 + length]
            self._handle_frame(conn, payload)
        if conn.closed:
            return
        if inbuf and conn.stall_deadline is None:
            # partial frame pending: the peer gets a bounded grace period
            conn.stall_deadline = time.monotonic() + MID_FRAME_STALL_SECONDS

    def _handle_frame(self, conn: _Conn, payload: bytes) -> None:
        self.metrics.counter("server.frames_in").inc()
        self.metrics.counter("server.bytes_in").inc(len(payload))
        if not conn.authed:
            self._handle_auth(conn, payload)
            return
        proto = conn.proto
        if proto == 2:
            if not payload or payload[0] != BINARY_MAGIC:
                self.metrics.counter("server.protocol_errors").inc()
                raise _Drop
            try:
                request = bloads(memoryview(payload)[1:])
            except Exception:
                self.metrics.counter("server.protocol_errors").inc()
                raise _Drop from None
        else:
            try:
                request = json.loads(payload)
            except json.JSONDecodeError:
                self.metrics.counter("server.protocol_errors").inc()
                raise _Drop from None
        if isinstance(request, dict) and "__ack_ops__" in request:
            # one-way replication ack from a subscriber — no response frame
            self._on_ack(int(request["__ack_ops__"]))
            return
        # chaos faults target *client* RPC frames only: replication-internal
        # traffic (subscriber acks above, subscriber RPCs below) is exempt so
        # an armed count lands on the frame the test aimed at
        fault = None
        fi = self.fault_injector
        if fi is not None and not conn.subscriber:
            fault = fi.on_frame()
            if fault == "drop_conn":
                self.metrics.counter("server.faults.dropped_conns").inc()
                raise _Drop
        batch = isinstance(request, list)
        seq0 = self._journal.end_seq if self._journal is not None else 0
        t0 = time.perf_counter()
        # events the wrapped backend records during dispatch carry the
        # *client* identity, so a fleet-wide trace attributes work to workers
        telemetry.set_worker_context(conn.peer)
        hello_proto = None
        subscribe_since: "int | None" = None
        try:
            encoded: list[bytes] = []
            for r in request if batch else [request]:
                response, blob = self.dispatch(
                    r, conn.specs, scope=conn.scope, proto=proto
                )
                encoded.append(blob)
                if not batch and isinstance(r, dict) and response.get("ok"):
                    m = r.get("method")
                    if m == "hello":
                        hello_proto = response["result"]["protocol"]
                    elif m == "subscribe_ops":
                        p = r.get("params") or []
                        subscribe_since = int(p[0]) if p else 0
        finally:
            telemetry.set_worker_context(None)
        if batch:
            # responses were serialized one by one (for per-method byte
            # accounting); assemble the batch frame compositionally instead
            # of re-serializing the whole list
            if proto == 2:
                body = bytes([BINARY_MAGIC]) + bjoin(encoded)
            else:
                body = b"[" + b",".join(encoded) + b"]"
            # the whole-frame view of a batched flush (tell_batch, the
            # write-behind drain): per-op latencies are recorded by dispatch;
            # this row pins the envelope cost clients feel
            self._note_rpc("batch", t0, len(body))
            self.metrics.counter("server.batched_ops").inc(len(encoded))
        else:
            body = (bytes([BINARY_MAGIC]) + encoded[0]) if proto == 2 else encoded[0]
        if fault == "blackhole":
            # the request *executed*; the response evaporates — exactly the
            # double-tell scenario the op-id dedup window must absorb
            self.metrics.counter("server.faults.blackholed_frames").inc()
        elif isinstance(fault, tuple) and fault[0] == "delay":
            self.metrics.counter("server.faults.delayed_frames").inc()
            self._delay_counter += 1
            heapq.heappush(
                self._delayed,
                (time.monotonic() + float(fault[1]), self._delay_counter, conn, body),
            )
        elif self._hold_for_ack(conn, body, seq0):
            pass  # semi-sync replication: released by the replica's ack
        else:
            self._send(conn, body)
        if hello_proto == 2:
            conn.proto = 2  # every later frame on this connection is binary
        if subscribe_since is not None:
            self._add_subscriber(conn, subscribe_since)

    def _handle_auth(self, conn: _Conn, payload: bytes) -> None:
        # the auth handshake is always JSON, whatever gets negotiated later
        try:
            request = json.loads(payload)
        except json.JSONDecodeError:
            self.metrics.counter("server.protocol_errors").inc()
            raise _Drop from None
        scope = self._auth_scope(request)
        if scope is not None:
            conn.authed = True
            conn.scope = scope
            response = {"id": request.get("id"), "ok": True, "result": "ok"}
        else:
            self.metrics.counter("server.auth_failures").inc()
            self.metrics.counter("server.auth_failures.bad_token").inc()
            response = {
                "id": request.get("id") if isinstance(request, dict) else None,
                "ok": False,
                "error": {
                    "type": "PermissionError",
                    "message": "storage server requires an auth token",
                },
            }
            conn.closing = True  # reply, flush, drop
        self._send(conn, json.dumps(response).encode())

    def _auth_scope(self, request: Any) -> "_Scope | None":
        if not isinstance(request, dict) or request.get("method") != "auth":
            return None
        params = request.get("params")
        if not isinstance(params, list) or len(params) != 1 or not isinstance(params[0], str):
            return None
        for token, scope in self._scopes:
            if hmac.compare_digest(params[0], token):
                return scope
        return None

    def _send(self, conn: _Conn, body: bytes) -> None:
        self.metrics.counter("server.frames_out").inc()
        self.metrics.counter("server.bytes_out").inc(len(body))
        conn.outbuf += struct.pack(">I", len(body))
        conn.outbuf += body
        self._write(conn)

    def _write(self, conn: _Conn) -> None:
        while conn.outbuf:
            try:
                n = conn.sock.send(memoryview(conn.outbuf))
            except (ssl.SSLWantWriteError, ssl.SSLWantReadError):
                break
            except (BlockingIOError, InterruptedError):
                break
            except (ConnectionError, OSError, ssl.SSLError):
                raise _Drop from None
            if n == 0:
                break
            del conn.outbuf[:n]
        if conn.outbuf:
            self._set_mask(conn, selectors.EVENT_READ | selectors.EVENT_WRITE)
            if conn.stall_deadline is None:
                # a peer that never drains its responses is as dead as one
                # that stalls mid-frame
                conn.stall_deadline = time.monotonic() + MID_FRAME_STALL_SECONDS
        else:
            self._set_mask(conn, selectors.EVENT_READ)
            if conn.closing:
                self._close_conn(conn)

    def _set_mask(self, conn: _Conn, mask: int) -> None:
        if mask != conn.mask and not conn.closed:
            try:
                self._sel.modify(conn.sock, mask, conn)
                conn.mask = mask
            except (ValueError, KeyError, OSError):
                raise _Drop from None

    def _sweep_stalled(self, now: float) -> None:
        for conn in list(self._conns):
            if conn.stall_deadline is not None and now >= conn.stall_deadline:
                self.metrics.counter("server.stalled_connections").inc()
                self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (ValueError, KeyError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.discard(conn)
        self.metrics.gauge("server.active_connections").add(-1)
        if conn.subscriber:
            self._subscribers.discard(conn)
            self.metrics.gauge("server.replication.subscribers").add(-1)
            if not self._subscribers and self._pending_acks and not self._closed:
                # the replica is gone: degrade to async rather than wedging
                # every client behind acks that will never come.  Not while
                # this node closes: a crash abandons its held responses, and
                # releasing them to clients whose sockets are not closed yet
                # would acknowledge writes no replica has
                self.metrics.counter("server.replication.degraded").inc()
                self._release_pending_acks(force=True)

    # -- replication ----------------------------------------------------------

    def _add_subscriber(self, conn: _Conn, since: int) -> None:
        """Register a replica's op-stream subscription and push the backlog."""
        conn.subscriber = True
        self._subscribers.add(conn)
        self.metrics.gauge("server.replication.subscribers").add(1)
        if self._journal is None:
            return
        backlog = self._journal.since(since)
        for i in range(0, len(backlog), _OP_BACKLOG_CHUNK):
            self._push_op_frame(conn, backlog[i : i + _OP_BACKLOG_CHUNK])

    def _stream_ops(self, ents: list[tuple]) -> None:
        """Push freshly journaled ops to every live subscriber."""
        if not self._subscribers:
            return
        for conn in list(self._subscribers):
            if conn.closed:
                continue
            try:
                self._push_op_frame(conn, ents)
            except _Drop:
                self._close_conn(conn)

    def _push_op_frame(self, conn: _Conn, ents: list[tuple]) -> None:
        if conn.proto == 2:
            body = bytes([BINARY_MAGIC]) + bdumps(
                {"__op_stream__": [list(e) for e in ents], "epoch": self.epoch}
            )
        else:
            wire = [[seq, op_id, method, pack(params)] for seq, op_id, method, params in ents]
            body = json.dumps({"__op_stream__": wire, "epoch": self.epoch}).encode()
        self.metrics.counter("server.replication.streamed_ops").inc(len(ents))
        self._send(conn, body)

    def _hold_for_ack(self, conn: _Conn, body: bytes, seq0: int) -> bool:
        """Semi-synchronous replication: when this frame journaled new ops and
        a subscriber is attached, the response is parked until the replica
        acks the journal suffix — a client-visible ack then implies the op
        survives a primary crash."""
        if not self.sync_replication or self._journal is None or conn.subscriber:
            return False
        if not self._subscribers:
            return False
        need = self._journal.end_seq
        if need <= seq0 or need <= self._acked_seq:
            return False
        self._pending_acks.append((need, conn, body))
        self.metrics.counter("server.replication.held_responses").inc()
        return True

    def _on_ack(self, seq: int) -> None:
        if seq > self._acked_seq:
            self._acked_seq = seq
            self.metrics.counter("server.replication.acks").inc()
        self._release_pending_acks()

    def _release_pending_acks(self, force: bool = False) -> None:
        while self._pending_acks and (force or self._pending_acks[0][0] <= self._acked_seq):
            _, conn, body = self._pending_acks.popleft()
            if conn.closed:
                continue
            try:
                self._send(conn, body)
            except _Drop:
                self._close_conn(conn)

    def _dedup_lookup(self, op_id: str) -> tuple[bool, Any]:
        with self._dedup_lock:
            if op_id in self._dedup:
                return True, self._dedup[op_id]
            return False, None

    def _dedup_store(self, op_id: str, result: Any) -> None:
        with self._dedup_lock:
            self._dedup[op_id] = result
            while len(self._dedup) > _DEDUP_WINDOW:
                self._dedup.popitem(last=False)

    def _journal_write(
        self, method: str, params: list, result: Any, op_id: "str | None"
    ) -> None:
        """Append a successful write dispatch to the op journal in its
        *replayable* form, and stream it to subscribers.  Fused and sweep ops
        are decomposed into the primitive writes a replica can re-execute."""
        entries: list[tuple["str | None", str, list]] = []
        if method == "report_and_prune":
            # only the value write mutates state; the prune decision is a
            # read the replica re-derives from its own peer data
            entries.append(
                (op_id, "set_trial_intermediate_value",
                 [params[1], int(params[2]), float(params[3])])
            )
        elif method in ("fail_stale_trials", "reclaim_stale_trials"):
            requeue = (
                method == "reclaim_stale_trials"
                and len(params) > 2
                and bool(params[2])
            )
            target = TrialState.WAITING if requeue else TrialState.FAIL
            for tid in result or []:
                entries.append((None, "set_trial_state_values", [tid, target, None]))
        else:
            entries.append((op_id, method, list(params)))
        ents = [self._journal.append(m, p, oid) for oid, m, p in entries]
        if ents:
            self._stream_ops(ents)

    def promote(self, epoch: "int | None" = None) -> dict[str, Any]:
        """Replica → primary under a bumped epoch.  Safe to call on a node
        that is already primary (idempotent)."""
        if self.role != "primary":
            tail = self._tail_handle
            if epoch is None:
                seen = getattr(tail, "seen_epoch", 0) if tail is not None else 0
                epoch = max(seen, self.epoch) + 1
            if tail is not None:
                tail.stop(join=False)
            self.role = "primary"
            self.epoch = int(epoch)
            self.metrics.counter("server.promotions").inc()
        return {
            "role": self.role,
            "epoch": self.epoch,
            "seq": self._journal.end_seq if self._journal is not None else 0,
        }

    def cluster_info(self) -> dict[str, Any]:
        return {
            "role": self.role,
            "epoch": self.epoch,
            "dedup": True,
            "seq": self._journal.end_seq if self._journal is not None else 0,
        }

    # -- dispatch -------------------------------------------------------------

    def dispatch(
        self,
        request: Any,
        conn_specs: "dict[int, dict] | None" = None,
        scope: "_Scope | None" = None,
        proto: int = 1,
    ) -> tuple[dict, bytes]:
        """Execute one RPC; returns ``(response, encoded_response)``.

        The response is serialized exactly once — the returned bytes are both
        the wire payload and the per-method byte-accounting sample."""
        enc = self._enc_json if proto == 1 else self._enc_bin
        if not isinstance(request, dict):
            request = {}
        req_id = request.get("id")
        method = request.get("method")
        t0 = time.perf_counter()
        try:
            if method == "ping":
                response = {"id": req_id, "ok": True, "result": "pong"}
                return response, enc(response)
            if method == "auth":
                # reaching dispatch means no token is required (or the
                # connection already authenticated); accept idempotently
                response = {"id": req_id, "ok": True, "result": "ok"}
                return response, enc(response)
            if method == "hello" and self.max_protocol >= 2:
                response = {"id": req_id, "ok": True, "result": self._hello(request)}
                return response, enc(response)
            if method == "get_server_metrics":
                response = {"id": req_id, "ok": True, "result": self.server_metrics()}
                return response, enc(response)
            if method == "get_cluster_info":
                response = {"id": req_id, "ok": True, "result": self.cluster_info()}
                return response, enc(response)
            if method == "promote":
                p = request.get("params") or []
                response = {
                    "id": req_id, "ok": True,
                    "result": self.promote(int(p[0]) if p and p[0] is not None else None),
                }
                return response, enc(response)
            if method == "subscribe_ops":
                if self._journal is None:
                    raise ValueError(
                        "replication requires a server started with journal=True"
                    )
                response = {
                    "id": req_id, "ok": True,
                    "result": {"epoch": self.epoch, "end_seq": self._journal.end_seq},
                }
                return response, enc(response)
            if method not in _METHODS:
                raise ValueError(f"unknown storage method {method!r}")
            params = request.get("params") or []
            if proto == 1:
                params = unpack(params)
            if method == "report_and_prune":
                spec = params[4] if len(params) > 4 and isinstance(params[4], dict) else None
                if spec is not None and "__spec_ref__" in spec:
                    self.metrics.counter("server.spec_cache.hits").inc()
                elif spec is not None and "__spec_def__" in spec:
                    self.metrics.counter("server.spec_cache.defs").inc()
                params = _resolve_spec(params, conn_specs)
            self._check_scope(method, params, scope)
            if method in _V2_ONLY and proto == 1:
                raise NotImplementedError(f"{method} requires wire protocol v2")
            op_id = request.get("op")
            if op_id is not None and method in _DEDUPED:
                hit, cached = self._dedup_lookup(op_id)
                if hit:
                    # retransmitted frame: answer from the dedup window — the
                    # original execution already happened (here, or on the
                    # primary this node replicated before promotion)
                    self.metrics.counter("server.dedup.hits").inc()
                    response = {
                        "id": req_id, "ok": True,
                        "result": pack(cached) if proto == 1 else cached,
                    }
                    blob = enc(response)
                    self._note_rpc(method, t0, len(blob))
                    return response, blob
            if self.role != "primary" and method in _WRITE_METHODS:
                raise StorageUnavailableError(
                    f"node is a replica (epoch {self.epoch}); writes need the primary"
                )
            result = self._invoke(method, params)
            if op_id is not None and method in _DEDUPED:
                self._dedup_store(op_id, result)
            if self._journal is not None and method in _WRITE_METHODS:
                self._journal_write(method, params, result, op_id)
            if self._track_trials:
                self._note_trial_ids(method, params, result)
            response = {
                "id": req_id,
                "ok": True,
                "result": pack(result) if proto == 1 else result,
            }
            # an unserializable result must become a typed error frame, not a
            # dropped connection (the client would silently retry + misreport)
            blob = enc(response)
            self._note_rpc(method, t0, len(blob))
            return response, blob
        except Exception as e:  # every failure maps to a typed client-side raise
            self._note_rpc(method, t0, 0, error=True)
            response = {
                "id": req_id,
                "ok": False,
                "error": {"type": type(e).__name__, "message": str(e)},
            }
            try:
                return response, enc(response)
            except Exception:  # pragma: no cover - unserializable error text
                response = {
                    "id": req_id,
                    "ok": False,
                    "error": {"type": "StorageInternalError", "message": "dispatch failed"},
                }
                return response, enc(response)

    @staticmethod
    def _enc_json(response: dict) -> bytes:
        return json.dumps(response).encode()

    @staticmethod
    def _enc_bin(response: dict) -> bytes:
        return bdumps(response)

    def _hello(self, request: dict) -> dict:
        params = request.get("params") or []
        want = 2
        if params and isinstance(params[0], dict):
            want = int(params[0].get("protocol", 2))
        # cluster extras piggyback on the negotiation so a failover-aware
        # client validates role/epoch without an extra round trip
        return {
            "protocol": max(1, min(want, self.max_protocol, 2)),
            "role": self.role,
            "epoch": self.epoch,
            "dedup": True,
        }

    def _check_scope(self, method: str, params: list, scope: "_Scope | None") -> None:
        if scope is None or scope.unrestricted:
            return
        if scope.readonly and method in _WRITE_METHODS:
            self._auth_failure("readonly")
            raise PermissionError(f"token is read-only; {method!r} is a write")
        studies = scope.studies
        if studies is None:
            return
        if method in _GLOBAL_SCOPED:
            self._auth_failure("study_scope")
            raise PermissionError(
                f"token is study-scoped; {method!r} is not study-addressable"
            )
        if method == "get_study_id_from_name":
            # resolve first: the id mapping itself is what the scope protects
            sid = self.storage.get_study_id_from_name(params[0])
        elif method in _TRIAL_SCOPED:
            sid = self._study_of_trial(int(params[0]), studies)
        else:
            sid = int(params[0])
        if sid not in studies:
            self._auth_failure("study_scope")
            raise PermissionError(f"token is not scoped to study {sid}")

    def _auth_failure(self, cause: str) -> None:
        self.metrics.counter("server.auth_failures").inc()
        self.metrics.counter(f"server.auth_failures.{cause}").inc()

    def _study_of_trial(self, trial_id: int, studies: "frozenset[int]") -> int:
        """Resolve a trial-addressed call to its study for scope checks: the
        map fills from create dispatches; unknown ids (trials created by
        another connection) fall back to one scan of the allowed studies."""
        sid = self._trial_study.get(trial_id)
        if sid is None:
            for s in sorted(studies):
                try:
                    for t in self.storage.get_all_trials(s, deepcopy=False):
                        self._trial_study.setdefault(t.trial_id, s)
                except Exception:
                    continue
            sid = self._trial_study.get(trial_id)
        if sid is None:
            self._auth_failure("study_scope")
            raise PermissionError(
                f"trial {trial_id} is outside this token's study scope"
            )
        return sid

    def _note_trial_ids(self, method: str, params: list, result: Any) -> None:
        if method == "create_new_trial" and isinstance(result, int):
            self._trial_study[result] = int(params[0])
        elif method == "create_new_trials" and isinstance(result, list):
            sid = int(params[0])
            for tid in result:
                self._trial_study[tid] = sid
        elif method == "get_trial_id_from_study_and_number" and isinstance(result, int):
            self._trial_study[result] = int(params[0])

    def _note_rpc(self, method: Any, t0: float, nbytes: int, error: bool = False) -> None:
        name = method if isinstance(method, str) else "invalid"
        self.metrics.counter(f"server.rpc.{name}.calls").inc()
        self.metrics.histogram(f"server.rpc.{name}").observe(time.perf_counter() - t0)
        if nbytes:
            self.metrics.counter(f"server.rpc.{name}.bytes_out").inc(nbytes)
        if error:
            self.metrics.counter(f"server.rpc.{name}.errors").inc()

    def server_metrics(self) -> dict[str, Any]:
        """JSON-safe metrics surface: per-method call counts / latency
        percentiles / bytes plus connection- and cache-level counters."""
        snap = self.metrics.snapshot()
        counters = snap["counters"]
        methods: dict[str, Any] = {}
        for name, h in snap["histograms"].items():
            if not name.startswith("server.rpc."):
                continue
            m = name[len("server.rpc."):]
            methods[m] = {
                "calls": counters.get(f"server.rpc.{m}.calls", 0),
                "errors": counters.get(f"server.rpc.{m}.errors", 0),
                "bytes_out": counters.get(f"server.rpc.{m}.bytes_out", 0),
                **{k: h[k] for k in ("count", "mean", "p50", "p95", "p99", "max")},
            }
        return {
            "uptime_s": time.time() - self.started_at,
            "active_connections": snap["gauges"].get("server.active_connections", 0),
            "auth_failures": counters.get("server.auth_failures", 0),
            "auth_failures_by_cause": {
                "bad_token": counters.get("server.auth_failures.bad_token", 0),
                "readonly": counters.get("server.auth_failures.readonly", 0),
                "study_scope": counters.get("server.auth_failures.study_scope", 0),
            },
            "protocol_errors": counters.get("server.protocol_errors", 0),
            "stalled_connections": counters.get("server.stalled_connections", 0),
            "frames_in": counters.get("server.frames_in", 0),
            "frames_out": counters.get("server.frames_out", 0),
            "bytes_in": counters.get("server.bytes_in", 0),
            "bytes_out": counters.get("server.bytes_out", 0),
            "spec_cache_hits": counters.get("server.spec_cache.hits", 0),
            "spec_cache_defs": counters.get("server.spec_cache.defs", 0),
            "batched_ops": counters.get("server.batched_ops", 0),
            "reclaimed_trials": counters.get("server.reclaimed_trials", 0),
            "dedup_hits": counters.get("server.dedup.hits", 0),
            "faults": {
                "dropped_connects": counters.get("server.faults.dropped_connects", 0),
                "dropped_conns": counters.get("server.faults.dropped_conns", 0),
                "blackholed_frames": counters.get("server.faults.blackholed_frames", 0),
                "delayed_frames": counters.get("server.faults.delayed_frames", 0),
            },
            "replication": {
                "role": self.role,
                "epoch": self.epoch,
                "seq": self._journal.end_seq if self._journal is not None else 0,
                "acked_seq": self._acked_seq,
                "subscribers": snap["gauges"].get("server.replication.subscribers", 0),
                "streamed_ops": counters.get("server.replication.streamed_ops", 0),
                "applied_ops": counters.get("server.replication.applied_ops", 0),
                "held_responses": counters.get("server.replication.held_responses", 0),
                "degraded": counters.get("server.replication.degraded", 0),
                "promotions": counters.get("server.promotions", 0),
                "reconnects": counters.get("server.replication.reconnects", 0),
            },
            "methods": methods,
        }

    def _invoke(self, method: str, params: list[Any]) -> Any:
        if method in ("get_all_trials", "get_n_trials"):
            # states arrives as a wire list; the API takes a tuple
            if method == "get_all_trials":
                study_id, deepcopy, states, since = params
                states = tuple(states) if states is not None else None
                if since is not None:
                    return get_trials_since(
                        self.storage, study_id, since, deepcopy=deepcopy, states=states
                    )
                return self.storage.get_all_trials(study_id, deepcopy=deepcopy, states=states)
            if method == "get_n_trials":
                study_id, states = params
                states = tuple(states) if states is not None else None
                return self.storage.get_n_trials(study_id, states=states)
        return getattr(self.storage, method)(*params)


def _resolve_spec(params: list, conn_specs: "dict[int, dict] | None") -> list:
    """Resolve the pruner-spec param of a fused report: a ``__spec_def__``
    envelope registers the full spec in this connection's cache, a
    ``__spec_ref__`` looks one up, and a raw spec dict (older clients, or
    in-process dispatch without connection state) passes through untouched."""
    if len(params) < 5 or not isinstance(params[4], dict):
        return params
    spec = params[4]
    if "__spec_def__" in spec:
        ent = spec["__spec_def__"]
        params = list(params)
        params[4] = ent["spec"]
        if conn_specs is not None:
            conn_specs[int(ent["id"])] = ent["spec"]
        return params
    if "__spec_ref__" in spec:
        ref = int(spec["__spec_ref__"])
        if conn_specs is None or ref not in conn_specs:
            raise ValueError(
                f"unknown pruner spec ref {ref} (connection lost its spec cache)"
            )
        params = list(params)
        params[4] = conn_specs[ref]
        return params
    return params


class _ReplicaTail:
    """Background thread on a replica: subscribes to the primary's op stream,
    replays every op into the local backend (preserving the primary's journal
    numbering and dedup window), and acks the applied sequence so a semi-sync
    primary can release held client responses.  Reconnects with jittered
    exponential backoff; ``stop()`` unblocks the socket and ends the loop."""

    def __init__(
        self,
        server: _RPCServer,
        host: str,
        port: int,
        auth_token: "str | None" = None,
        protocol: int = 2,
    ):
        self._server = server
        self._host = host
        self._port = port
        self._auth_token = auth_token
        self._protocol = protocol
        self.applied = server._journal.end_seq  # next seq we expect
        self.seen_epoch = 0  # highest primary epoch observed on the stream
        self._stop = threading.Event()
        self._sock: "socket.socket | None" = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._next_id = 0

    def start(self) -> "_ReplicaTail":
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()  # unblock a recv in progress
            except OSError:
                pass
        if join and self._thread.is_alive() and threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    def _req_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def _run(self) -> None:
        import random

        rng = random.Random(id(self) & 0xFFFF)
        attempt = 0
        while not self._stop.is_set():
            try:
                self._connect_and_tail()
                attempt = 0
            except Exception:
                if self._stop.is_set():
                    break
                self._server.metrics.counter("server.replication.reconnects").inc()
                attempt += 1
                delay = min(1.0, 0.05 * (2 ** min(attempt, 5))) * (0.5 + rng.random())
                self._stop.wait(delay)

    def _rpc(self, sock: socket.socket, proto: int, method: str, params: list) -> Any:
        request = {"id": self._req_id(), "method": method, "params": params}
        if proto == 2:
            send_frame(sock, bytes([BINARY_MAGIC]) + bdumps(request))
        else:
            send_frame(sock, json.dumps({**request, "params": pack(params)}).encode())
        body = self._recv(sock)
        if body is None:
            raise ConnectionError("primary closed during rpc")
        response = bloads(memoryview(body)[1:]) if proto == 2 else json.loads(body)
        if not response.get("ok"):
            err = response.get("error") or {}
            raise ConnectionError(f"primary rejected {method}: {err.get('message')}")
        result = response.get("result")
        return result if proto == 2 else unpack(result)

    def _recv(self, sock: socket.socket) -> "bytes | None":
        """recv_frame that treats idle timeouts as 'check the stop flag'."""
        while True:
            try:
                return recv_frame(sock)
            except socket.timeout:
                if self._stop.is_set():
                    raise ConnectionError("tail stopped") from None

    def _connect_and_tail(self) -> None:
        sock = socket.create_connection((self._host, self._port), timeout=5.0)
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(1.0)  # poll the stop flag while idle
            if self._auth_token is not None:
                request = {"id": self._req_id(), "method": "auth", "params": [self._auth_token]}
                send_frame(sock, json.dumps(request).encode())
                body = self._recv(sock)
                if body is None or not json.loads(body).get("ok"):
                    raise ConnectionError("replication auth rejected")
            proto = 1
            if self._protocol >= 2:
                request = {"id": self._req_id(), "method": "hello", "params": [{"protocol": 2}]}
                send_frame(sock, json.dumps(request).encode())
                body = self._recv(sock)
                if body is None:
                    raise ConnectionError("primary closed during hello")
                response = json.loads(body)
                if response.get("ok") and int(response["result"].get("protocol", 1)) >= 2:
                    proto = 2
            sub = self._rpc(sock, proto, "subscribe_ops", [self.applied])
            self.seen_epoch = max(self.seen_epoch, int(sub.get("epoch", 0)))
            while not self._stop.is_set():
                body = self._recv(sock)
                if body is None:
                    raise ConnectionError("primary closed the op stream")
                if proto == 2:
                    msg = bloads(memoryview(body)[1:])
                else:
                    msg = json.loads(body)
                ops = msg.get("__op_stream__") if isinstance(msg, dict) else None
                if ops is None:
                    continue  # not an op frame; ignore
                self.seen_epoch = max(self.seen_epoch, int(msg.get("epoch", 0)))
                for seq, op_id, method, params in ops:
                    if proto == 1:
                        params = unpack(params)
                    self._apply(int(seq), op_id, method, params)
                # ack the whole frame at once: one frame back per frame in
                ack = {"__ack_ops__": self.applied}
                if proto == 2:
                    send_frame(sock, bytes([BINARY_MAGIC]) + bdumps(ack))
                else:
                    send_frame(sock, json.dumps(ack).encode())
        finally:
            self._sock = None
            try:
                sock.close()
            except OSError:
                pass

    def _apply(self, seq: int, op_id: "str | None", method: str, params: list) -> None:
        if seq < self.applied:
            return  # overlap with an already-replayed backlog
        srv = self._server
        try:
            result = getattr(srv.storage, method)(*params)
        except Exception:
            # a replayed op must never kill the tail; record and move on
            result = None
            srv.metrics.counter("server.replication.apply_errors").inc()
        srv._journal.append_at(seq, op_id, method, params)
        if op_id is not None:
            # a retransmit that lands here after promotion answers from this
            # window; None (e.g. a decomposed fused report) degrades to a
            # conservative falsy result
            srv._dedup_store(op_id, result if result is not None else False)
        self.applied = seq + 1
        srv.metrics.counter("server.replication.applied_ops").inc()


class StorageServer:
    """Serve a storage backend over TCP.

    >>> server = StorageServer(SQLiteStorage("study.db")).start()
    >>> server.url          # hand this to workers on other machines
    'remote://10.0.0.5:38211'
    >>> server.stop()

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    Usable as a context manager.

    ``auth_token`` arms a shared-secret handshake: every connection must
    present the token in its first frame (``RemoteStorage`` does this
    automatically for ``remote://token@host:port`` URLs or an explicit
    ``auth_token=``) or it is rejected with ``PermissionError`` and dropped.
    ``auth_tokens`` adds *scoped* tokens — dicts of ``{"token": str,
    "readonly": bool, "studies": [ids] | None}`` — whose violations raise
    ``PermissionError`` on the offending call (the connection survives).

    ``tls_cert``/``tls_key`` (PEM paths) wrap every connection in TLS;
    clients then connect via ``remote+tls://host:port`` (authentication
    still runs inside the encrypted channel).  Without TLS the wire is
    plaintext — run inside a trusted network or tunnel for confidentiality.

    ``max_protocol=1`` pins the server to JSON frames (the ``hello``
    negotiation is answered as an unknown method, exactly like a pre-v2
    server), which v2 clients transparently fall back from.

    Cluster / fault-tolerance knobs (DESIGN.md "Cluster"):

    * ``journal=True`` — keep a replayable op journal so replicas can
      subscribe (implied by ``replicate_from`` / ``sync_replication``).
    * ``replicate_from="remote://host:port"`` — start as a *replica* of that
      primary: refuse writes, tail its op stream, replay into the local
      backend.  :meth:`promote` flips it to primary under a bumped epoch.
    * ``sync_replication=True`` — hold each write's client response until a
      subscribed replica acks the op (degrades to async with no subscriber).
    * ``fault_injector`` — a :class:`~.chaos.FaultInjector` for chaos tests.
    * ``reclaim_grace`` — sweep interval-driven stale-RUNNING reclamation:
      trials with no heartbeat for that many seconds are FAILed, or requeued
      as WAITING with ``reclaim_requeue=True``.
    * :meth:`kill` — simulated crash (no response flush); :meth:`restart`
      re-binds the same port over the same backend object.
    """

    def __init__(
        self, storage: BaseStorage, host: str = "127.0.0.1", port: int = 0,
        auth_token: "str | None" = None, auth_tokens: "list | None" = None,
        tls_cert: "str | None" = None, tls_key: "str | None" = None,
        max_protocol: int = 2,
        journal: bool = False,
        replicate_from: "str | None" = None,
        sync_replication: bool = False,
        epoch: int = 1,
        fault_injector: Any = None,
        reclaim_grace: "float | None" = None,
        reclaim_requeue: bool = False,
        reclaim_interval: float = 1.0,
    ):
        if (tls_cert is None) != (tls_key is None):
            raise ValueError("tls_cert and tls_key must be given together")
        self._storage = storage
        self._host = host
        self._requested_port = port
        self._auth_token = auth_token
        self._auth_tokens = auth_tokens
        self._tls_cert = tls_cert
        self._tls_key = tls_key
        self._max_protocol = max_protocol
        self._replicate_from = replicate_from
        self._journal_enabled = bool(journal or replicate_from or sync_replication)
        self._journal = OpJournal() if self._journal_enabled else None
        self._sync_replication = sync_replication
        self._epoch = int(epoch)
        self._role = "replica" if replicate_from else "primary"
        self._fault_injector = fault_injector
        self._reclaim_grace = reclaim_grace
        self._reclaim_requeue = reclaim_requeue
        self._reclaim_interval = reclaim_interval
        self._server: _RPCServer | None = None
        self._thread: threading.Thread | None = None
        self._tail: "_ReplicaTail | None" = None

    def start(self) -> "StorageServer":
        if self._server is not None:
            return self
        ssl_context = None
        if self._tls_cert is not None:
            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(self._tls_cert, self._tls_key)
        self._server = _RPCServer(
            (self._host, self._requested_port), self._storage,
            auth_token=self._auth_token, auth_tokens=self._auth_tokens,
            ssl_context=ssl_context, max_protocol=self._max_protocol,
            journal=self._journal, role=self._role, epoch=self._epoch,
            sync_replication=self._sync_replication,
            fault_injector=self._fault_injector,
            reclaim_grace=self._reclaim_grace,
            reclaim_requeue=self._reclaim_requeue,
            reclaim_interval=self._reclaim_interval,
        )
        # remember the bound port so kill()/restart() resurrects the same URL
        self._requested_port = self._server.server_address[1]
        if self._replicate_from is not None and self._tail is None:
            from .client import parse_remote_candidates

            candidates, token, _tls = parse_remote_candidates(self._replicate_from)
            self._tail = _ReplicaTail(
                self._server, candidates[0][0], candidates[0][1],
                auth_token=token or self._auth_token,  # shared-secret cluster
                protocol=self._max_protocol,
            ).start()
            self._server._tail_handle = self._tail
        elif self._tail is not None:
            self._server._tail_handle = self._tail
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1}, daemon=True
        )
        self._thread.start()
        return self

    @property
    def host(self) -> str:
        return self._host

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.server_address[1]

    @property
    def tls(self) -> bool:
        return self._tls_cert is not None

    @property
    def url(self) -> str:
        scheme = "remote+tls" if self.tls else "remote"
        return f"{scheme}://{self.host}:{self.port}"

    def get_server_metrics(self) -> dict[str, Any]:
        """The live metrics surface (same payload the ``get_server_metrics``
        RPC returns to :class:`RemoteStorage` clients)."""
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.server_metrics()

    def stop(self) -> None:
        if self._server is None:
            return
        if self._tail is not None:
            self._tail.stop()
            self._tail = None
        self._server.stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server.close()  # idempotent; covers a loop that died early
        self._server = None
        self._thread = None

    def kill(self) -> None:
        """Simulated crash: sockets close without flushing responses, held
        (semi-sync) responses are abandoned, the replica tail dies.  The
        backend object survives — :meth:`restart` brings the node back on the
        same port, like a process restart over durable storage."""
        if self._server is None:
            return
        if self._tail is not None:
            self._tail.stop()
            self._tail = None
        self._server._kill.set()
        self._server.stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server.close(flush=False)
        self._server = None
        self._thread = None

    def restart(self) -> "StorageServer":
        """Bring a stopped/killed node back on the same host:port."""
        return self.start()

    def promote(self, epoch: "int | None" = None) -> dict[str, Any]:
        """Replica → primary: stop tailing the (dead) upstream, accept writes
        under a bumped epoch.  Returns ``{"role", "epoch", "seq"}``."""
        if self._server is None:
            raise RuntimeError("server not started")
        tail, self._tail = self._tail, None
        if tail is not None:
            tail.stop()  # join: every received op is applied before we flip
        info = self._server.promote(epoch)
        # keep wrapper state in sync so a later kill()/restart() stays primary
        self._role = info["role"]
        self._epoch = info["epoch"]
        self._replicate_from = None
        return info

    @property
    def role(self) -> str:
        return self._server.role if self._server is not None else self._role

    @property
    def epoch(self) -> int:
        return self._server.epoch if self._server is not None else self._epoch

    @property
    def fault_injector(self) -> Any:
        return self._fault_injector

    @property
    def storage(self) -> BaseStorage:
        return self._storage

    @property
    def journal(self) -> "OpJournal | None":
        return self._journal

    def replication_state(self) -> dict[str, Any]:
        """Live replication view: journal seq, acked seq, applied seq (on a
        replica), role and epoch — what the chaos harness polls."""
        srv = self._server
        tail = self._tail
        return {
            "role": self.role,
            "epoch": self.epoch,
            "seq": self._journal.end_seq if self._journal is not None else 0,
            "acked_seq": srv._acked_seq if srv is not None else 0,
            "applied_seq": tail.applied if tail is not None else None,
        }

    def __enter__(self) -> "StorageServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def main(argv: list[str] | None = None) -> None:
    """``python -m repro_torch.core.storage.server sqlite:///study.db --port 9000``"""
    import argparse

    from . import get_storage

    ap = argparse.ArgumentParser(description="serve a storage backend over remote://")
    ap.add_argument("storage", help="backend URL to wrap (sqlite:/// or journal://)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument(
        "--auth-token",
        default=os.environ.get("REPRO_STORAGE_TOKEN"),
        help="shared secret; clients connect with remote://TOKEN@host:port "
        "(default: $REPRO_STORAGE_TOKEN)",
    )
    ap.add_argument(
        "--readonly-token",
        default=None,
        help="additional shared secret granting read-only access",
    )
    ap.add_argument("--tls-cert", default=None, help="PEM certificate; enables TLS")
    ap.add_argument("--tls-key", default=None, help="PEM private key; enables TLS")
    ap.add_argument(
        "--max-protocol", type=int, default=2, choices=(1, 2),
        help="1 pins the wire to legacy JSON frames",
    )
    ap.add_argument(
        "--journal", action="store_true",
        help="record executed writes in a replayable op journal (required "
        "to serve replicas)",
    )
    ap.add_argument(
        "--sync-replication", action="store_true",
        help="hold client write responses until a connected replica acks "
        "(implies --journal; acked writes survive primary loss)",
    )
    ap.add_argument(
        "--replicate-from", default=None, metavar="URL",
        help="start as a replica tailing this primary's op journal; promote "
        "later with the 'promote' RPC",
    )
    ap.add_argument(
        "--reclaim-grace", type=float, default=None, metavar="SECONDS",
        help="FAIL RUNNING trials whose worker stopped heartbeating for "
        "this many seconds (server-side sweep)",
    )
    ap.add_argument(
        "--reclaim-requeue", action="store_true",
        help="re-enqueue reclaimed trials as WAITING instead of FAILing them",
    )
    args = ap.parse_args(argv)

    auth_tokens = None
    if args.readonly_token:
        auth_tokens = [{"token": args.readonly_token, "readonly": True}]
    server = StorageServer(
        get_storage(args.storage), host=args.host, port=args.port,
        auth_token=args.auth_token, auth_tokens=auth_tokens,
        tls_cert=args.tls_cert, tls_key=args.tls_key,
        max_protocol=args.max_protocol,
        journal=args.journal or args.sync_replication,
        sync_replication=args.sync_replication,
        replicate_from=args.replicate_from,
        reclaim_grace=args.reclaim_grace,
        reclaim_requeue=args.reclaim_requeue,
    ).start()
    print(f"serving {args.storage} at {server.url} (ctrl-c to stop)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()

"""``RemoteStorage`` — the client half of the networked storage service.

Connects to a :class:`~repro_torch.core.storage.server.StorageServer` via a
``remote://host:port`` URL and implements the full :class:`BaseStorage`
contract by forwarding each call as one JSON-RPC frame (see server.py for the
wire format).

Design points:

* **Per-thread connections** — ``study.optimize(n_jobs=k)`` threads each get
  their own socket, so responses can never interleave.
* **Retry-on-reconnect** — a dropped connection is re-dialed transparently.
  Idempotent calls (all reads, value-overwriting writes) are retried; calls
  whose *effect* is not idempotent (``create_new_trial``,
  ``create_new_study``, the WAITING->RUNNING claim) are only retried when the
  request provably never reached the wire, otherwise
  :class:`RetryableStorageError` is raised for the caller to decide.
* **Atomic compare-and-set** — ``set_trial_state_values`` executes inside the
  single server process against the wrapped backend, so ``ask()``'s
  WAITING-claim race stays exactly-once across machines.
* **Failover** — a URL may list ``+``-separated candidates
  (``remote://primary:p1+replica:p2``).  The client validates role and epoch
  at connect time (cluster extras ride the ``hello``), refuses replicas and
  stale-epoch primaries, and rotates to the next candidate with jittered
  exponential backoff under a per-RPC deadline.  Non-idempotent calls carry
  an ``op`` id; against a dedup-capable server a torn-connection retransmit
  can never double-execute, so even ``tell`` survives a mid-flight failover.
"""

from __future__ import annotations

import json
import os
import random
import socket
import ssl
import threading
import time
import uuid
from typing import Any, Iterable

from .. import telemetry
from ..exceptions import (
    DuplicatedStudyError,
    RetryableStorageError,
    StorageInternalError,
    StorageUnavailableError,
    StudyNotFoundError,
    TrialNotFoundError,
)
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseStorage, StudySummary
from .serde import BINARY_MAGIC, bdumps, bloads, pack, unpack
from .server import recv_frame, send_frame

_MAGIC = bytes([BINARY_MAGIC])

__all__ = ["RemoteStorage", "parse_remote_url", "parse_remote_candidates"]

# server-side exception type name -> client-side class to re-raise
_ERROR_TYPES: dict[str, type[Exception]] = {
    "StudyNotFoundError": StudyNotFoundError,
    "TrialNotFoundError": TrialNotFoundError,
    "DuplicatedStudyError": DuplicatedStudyError,
    "StorageInternalError": StorageInternalError,
    "RetryableStorageError": RetryableStorageError,
    "StorageUnavailableError": StorageUnavailableError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TypeError": TypeError,
    "KeyError": KeyError,
    "PermissionError": PermissionError,
    "NotImplementedError": NotImplementedError,
}

# Calls that may NOT be blindly re-sent after a torn connection: re-executing
# them would create a second trial/study or turn a won claim into a lost one.
# (Against a dedup-capable server they travel with an ``op`` id and become
# safely retransmittable — see ``_call_raw``.)
_NON_IDEMPOTENT = frozenset(
    {"create_new_study", "create_new_trial", "create_new_trials", "set_trial_state_values"}
)

# methods that carry an ``op`` idempotency token (the server's dedup window
# also caches the fused report's prune decision)
_OP_STAMPED = _NON_IDEMPOTENT | {"report_and_prune"}


def parse_remote_url(url: str) -> tuple[str, int]:
    host, port, _, _ = parse_remote_url_auth(url)
    return host, port


def parse_remote_url_auth(url: str) -> tuple[str, int, "str | None", bool]:
    """Parse ``remote[+tls]://[token@]host:port`` into
    (host, port, token, tls) — the *first* candidate of a failover list."""
    candidates, token, tls = parse_remote_candidates(url)
    host, port = candidates[0]
    return host, port, token, tls


def parse_remote_candidates(
    url: str,
) -> tuple[list[tuple[str, int]], "str | None", bool]:
    """Parse ``remote[+tls]://[token@]h1:p1[+h2:p2...]`` into
    (candidates, token, tls).  ``+``-separated host:port pairs are failover
    candidates for the *same* logical node (primary first, then replicas);
    sharding across *different* nodes uses commas and is handled one level
    up by :class:`~repro_torch.core.storage.cluster.ShardedStorage`."""
    tls = False
    if url.startswith("remote+tls://"):
        tls = True
        hostport = url[len("remote+tls://"):].rstrip("/")
    elif url.startswith("remote://"):
        hostport = url[len("remote://"):].rstrip("/")
    else:
        raise ValueError(f"not a remote:// URL: {url!r}")
    token: str | None = None
    if "@" in hostport:
        token, _, hostport = hostport.rpartition("@")
        token = token or None
    candidates: list[tuple[str, int]] = []
    for part in hostport.split("+"):
        host, sep, port = part.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"remote:// URL needs host:port, got {url!r}")
        candidates.append((host, int(port)))
    if not candidates:
        raise ValueError(f"remote:// URL has no candidates: {url!r}")
    return candidates, token, tls


class RemoteStorage(BaseStorage):
    """Storage proxy speaking the length-prefixed remote protocol.

    Args:
        url: ``remote://host:port`` (or ``remote+tls://host:port``) of a
            running :class:`StorageServer`.  A shared-secret token may be
            embedded as ``remote://token@host:port``.
        timeout: per-call socket timeout in seconds.
        retries: reconnect attempts per call before giving up.
        auth_token: shared secret for servers started with one.  Falls back
            to the URL userinfo, then the ``REPRO_STORAGE_TOKEN`` env var.
            Sent once per connection as an ``auth`` handshake frame; the
            server drops unauthenticated connections when configured.
        protocol: highest wire protocol to negotiate.  ``2`` (default) sends
            a ``hello`` after auth and switches the connection to binary
            frames when the server agrees; a JSON-only server answers with
            an unknown-method error and the client silently stays on v1.
            ``1`` pins the client to legacy JSON frames.
        tls_ca: PEM bundle to verify the server certificate against for
            ``remote+tls://`` URLs (falls back to ``$REPRO_STORAGE_TLS_CA``,
            then the system trust store).
        rpc_deadline: wall-clock budget per logical call, in seconds.  All
            reconnects, candidate rotations, and backoff sleeps for one call
            must fit inside it; ``None`` disables the budget (``retries``
            still caps attempts).
        backoff_base / backoff_cap: jittered exponential backoff between
            reconnect attempts — sleep ``min(cap, base * 2^k) * uniform(0.5,
            1.5)``.
        backoff_seed: seed for the backoff/jitter RNG (deterministic chaos
            tests); ``None`` seeds from the OS.
    """

    def __init__(
        self, url: str, timeout: float = 30.0, retries: int = 3,
        auth_token: "str | None" = None, protocol: int = 2,
        tls_ca: "str | None" = None, rpc_deadline: "float | None" = 60.0,
        backoff_base: float = 0.05, backoff_cap: float = 2.0,
        backoff_seed: "int | None" = None,
    ):
        self._candidates, url_token, self._tls = parse_remote_candidates(url)
        self._host, self._port = self._candidates[0]
        self._auth_token = auth_token or url_token or os.environ.get("REPRO_STORAGE_TOKEN")
        scheme = "remote+tls" if self._tls else "remote"
        # token never echoed
        self._url = f"{scheme}://" + "+".join(f"{h}:{p}" for h, p in self._candidates)
        self._timeout = timeout
        self._retries = max(1, retries)
        self._protocol = protocol
        self._rpc_deadline = rpc_deadline
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        self._rng = random.Random(backoff_seed)
        self._ssl_context: ssl.SSLContext | None = None
        if self._tls:
            cafile = tls_ca or os.environ.get("REPRO_STORAGE_TLS_CA")
            self._ssl_context = ssl.create_default_context(cafile=cafile)
        # set once the server answers hello with an unknown-method error:
        # later connections (and re-dials) skip the doomed negotiation
        self._server_is_v1 = False
        # -- failover state (shared across threads; races are benign — a
        # stale _active just costs one extra dial) --
        self._active = 0           # index of the candidate serving us
        self._epoch_seen = 0       # highest primary epoch ever observed
        self._dedup_ok = False     # server keeps an op-id dedup window
        self._client_uid = uuid.uuid4().hex[:12]  # namespace for op ids
        self._local = threading.local()
        self._id_lock = threading.Lock()
        self._next_id = 0
        self._call("ping")  # fail fast on a bad address (or a bad token)

    @property
    def url(self) -> str:
        return self._url

    @property
    def protocol(self) -> int:
        """The wire protocol negotiated on this thread's connection (dials
        one if the thread has never talked to the server)."""
        if getattr(self._local, "sock", None) is None:
            self._call("ping")
        return getattr(self._local, "proto", 1)

    @property
    def supports_block_fetch(self) -> bool:
        """Whether the columnar block RPCs are worth attempting (callers
        still handle ``NotImplementedError`` — negotiation is per-thread)."""
        if self._protocol < 2 or self._server_is_v1:
            return False
        return True

    # -- transport -------------------------------------------------------------

    def _sock(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            return sock
        n = len(self._candidates)
        last: Exception | None = None
        start = self._active
        for k in range(n):
            idx = (start + k) % n
            host, port = self._candidates[idx]
            try:
                sock = self._dial(host, port)
            except PermissionError:
                raise  # bad token: the next candidate shares it, don't spin
            except (OSError, ConnectionError) as e:
                last = e
                self._drop_sock()
                continue
            if idx != self._active:
                self._active = idx
                telemetry.inc("client.failovers")
            return sock
        assert last is not None
        raise last

    def _dial(self, host: str, port: int) -> socket.socket:
        sock = socket.create_connection((host, port), timeout=self._timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl_context is not None:
                sock = self._ssl_context.wrap_socket(sock, server_hostname=host)
        except BaseException:
            sock.close()
            raise
        telemetry.inc("client.connects")
        if getattr(self._local, "ever_connected", False):
            telemetry.inc("client.reconnects")  # re-dial after a torn socket
        self._local.ever_connected = True
        self._local.sock = sock
        self._local.proto = 1
        if self._auth_token is not None:
            self._authenticate(sock)
        hello_info: "dict | None" = None
        if self._protocol >= 2 and not self._server_is_v1:
            hello_info = self._negotiate(sock)
        self._validate_cluster(sock, hello_info)
        return sock

    def _negotiate(self, sock: socket.socket) -> "dict | None":
        """Offer wire protocol v2 via a JSON ``hello``; on agreement the
        connection switches to binary frames for everything that follows.
        Returns the hello result (which carries the cluster extras
        ``role``/``epoch``/``dedup`` on fault-tolerant servers)."""
        request = {
            "id": self._req_id(), "method": "hello",
            "params": [{"protocol": min(self._protocol, 2)}],
        }
        try:
            send_frame(sock, json.dumps(request).encode())
            body = recv_frame(sock)
        except (OSError, ConnectionError):
            self._drop_sock()
            raise
        if body is None:
            self._drop_sock()
            raise ConnectionError("server closed the connection during hello")
        response = json.loads(body)
        if response.get("ok"):
            if int(response["result"].get("protocol", 1)) >= 2:
                self._local.proto = 2
                telemetry.inc("client.protocol_v2_connects")
            return response["result"]
        # pre-v2 server: "unknown storage method 'hello'" — remember and
        # stay on JSON so re-dials skip the wasted round trip
        self._server_is_v1 = True
        telemetry.inc("client.protocol_fallbacks")
        return None

    # -- cluster awareness -----------------------------------------------------

    def _validate_cluster(self, sock: socket.socket, hello_info: "dict | None") -> None:
        """Refuse un-promoted replicas and fenced (stale-epoch) primaries at
        connect time, so a worker never writes into a node that will lose the
        failover.  Raises ``ConnectionError`` — ``_sock`` rotates onward."""
        info = hello_info if hello_info and "role" in hello_info else None
        if info is None:
            # v1 connection (or a hello that carried no cluster extras):
            # probe explicitly, but only when there is actually a failover
            # list — a single legacy server shouldn't pay the round trip
            if len(self._candidates) <= 1:
                return
            info = self._cluster_info_rpc(sock)
            if info is None:
                return  # legacy server: no cluster support, nothing to check
        role = info.get("role", "primary")
        epoch = int(info.get("epoch", 1))
        if role != "primary" and len(self._candidates) > 1:
            # an explicit single-node URL aimed at a replica stays usable for
            # diagnostic reads (writes get StorageUnavailableError from the
            # server); with a failover list we keep hunting for the primary
            raise ConnectionError(
                f"candidate is a {role} (epoch {epoch}); looking for the primary"
            )
        if epoch < self._epoch_seen:
            # an old primary restarted after its replica was promoted: writing
            # to it would fork history.  Treat it as dead until it re-syncs.
            raise ConnectionError(
                f"fenced primary: epoch {epoch} < highest seen {self._epoch_seen}"
            )
        self._epoch_seen = max(self._epoch_seen, epoch)
        if info.get("dedup"):
            self._dedup_ok = True

    def _cluster_info_rpc(self, sock: socket.socket) -> "dict | None":
        proto = getattr(self._local, "proto", 1)
        request = {"id": self._req_id(), "method": "get_cluster_info", "params": []}
        send_frame(sock, self._encode_payload(request, proto))
        body = recv_frame(sock)
        if body is None:
            raise ConnectionError("server closed the connection during cluster probe")
        if proto == 2 and body and body[0] == BINARY_MAGIC:
            response, rich = bloads(memoryview(body)[1:]), True
        else:
            response, rich = json.loads(body), False
        try:
            return self._unwrap(response, rich)
        except Exception:
            return None  # unknown-method error: a server without cluster support

    def _authenticate(self, sock: socket.socket) -> None:
        """Per-connection handshake: the first frame carries the shared
        secret; everything else is rejected by a token-protected server."""
        request = {"id": self._req_id(), "method": "auth", "params": [self._auth_token]}
        try:
            send_frame(sock, json.dumps(request).encode())
            body = recv_frame(sock)
        except (OSError, ConnectionError):
            self._drop_sock()
            raise
        if body is None:
            self._drop_sock()
            raise ConnectionError("server closed the connection during auth")
        try:
            self._unwrap(json.loads(body))  # raises PermissionError on a bad token
        except Exception:
            # the server drops rejected connections: never cache the socket,
            # or the next call would surface a torn-connection error instead
            # of the real auth failure
            self._drop_sock()
            raise

    def _drop_sock(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None
            self._local.proto = 1  # the next dial renegotiates
            # the server's per-connection spec cache died with the socket;
            # dropping here (never at connect time) keeps a def registered at
            # encode time valid for the send that follows on a fresh dial
            self._local.spec_ids = {}

    def _req_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id

    def _encode_payload(self, request: Any, proto: int) -> bytes:
        if proto == 2:
            # binary frames carry rich params natively — no pack() pass
            return _MAGIC + bdumps(request)
        if isinstance(request, list):
            wire = [{**r, "params": pack(r["params"])} for r in request]
        else:
            wire = {**request, "params": pack(request["params"])}
        return json.dumps(wire).encode()

    def _roundtrip(self, request: Any, payloads: dict[int, bytes]) -> Any:
        """Send one frame, read one frame.  ``payloads`` caches the encoded
        request per protocol, so the bytes survive the retry loop (a re-dial
        that renegotiates the same protocol re-sends without re-encoding).
        Transport failures carry a ``_rpc_sent`` attribute."""
        try:
            sock = self._sock()
        except PermissionError:
            raise  # bad auth token: surface immediately, never retry
        except (OSError, ConnectionError) as e:
            # connect/auth-transport failure: the request never hit the wire
            e._rpc_sent = False  # type: ignore[attr-defined]
            raise
        proto = getattr(self._local, "proto", 1)
        payload = payloads.get(proto)
        if payload is None:
            payload = payloads[proto] = self._encode_payload(request, proto)
        sent = False
        try:
            send_frame(sock, payload)
            sent = True
            telemetry.inc("client.frames_out")
            telemetry.inc("client.bytes_out", len(payload))
            body = recv_frame(sock)
        except (OSError, ConnectionError) as e:
            self._drop_sock()
            e._rpc_sent = sent  # type: ignore[attr-defined]
            raise
        if body is None:
            self._drop_sock()
            e = ConnectionError("server closed the connection")
            e._rpc_sent = True  # type: ignore[attr-defined]
            raise e
        telemetry.inc("client.frames_in")
        telemetry.inc("client.bytes_in", len(body))
        if proto == 2:
            if not body or body[0] != BINARY_MAGIC:
                self._drop_sock()
                e = ConnectionError("malformed binary frame from server")
                e._rpc_sent = True  # type: ignore[attr-defined]
                raise e
            return bloads(memoryview(body)[1:]), True
        return json.loads(body), False

    def _sleep_backoff(self, k: int, deadline: "float | None") -> None:
        """Jittered exponential backoff before attempt ``k+1`` (k >= 1),
        clamped so the sleep never overshoots the per-call deadline."""
        d = min(self._backoff_cap, self._backoff_base * (2 ** min(k - 1, 8)))
        d *= 0.5 + self._rng.random()
        if deadline is not None:
            d = min(d, max(0.0, deadline - time.monotonic()))
        if d > 0:
            telemetry.inc("client.backoff_ms", int(d * 1000))
            time.sleep(d)

    def _call_raw(
        self, request: Any, *, idempotent: bool, deduped: bool = False,
        deadline: "float | None" = None,
    ) -> tuple[Any, bool]:
        """Returns ``(decoded_response, rich)`` — ``rich`` meaning the
        response came over v2 and needs no serde unpack.

        ``deduped`` marks a request stamped with an ``op`` id: against a
        dedup-capable server it may be retransmitted even after it hit the
        wire (re-execution is suppressed server-side), which closes the
        torn-``tell`` window that plain non-idempotent calls must refuse.
        """
        payloads: dict[int, bytes] = {}
        last: Exception | None = None
        for attempt in range(1, self._retries + 1):
            try:
                return self._roundtrip(request, payloads)
            except PermissionError:
                raise  # auth rejection is terminal (PermissionError < OSError)
            except (OSError, ConnectionError) as e:
                last = e
                sent = getattr(e, "_rpc_sent", True)
                if sent and not idempotent:
                    if not (deduped and self._dedup_ok):
                        raise RetryableStorageError(
                            f"connection to {self._url} died after a non-idempotent "
                            f"request was sent; cannot safely retry: {e}"
                        ) from e
                    telemetry.inc("client.dedup_retransmits")
                if attempt >= self._retries:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                telemetry.inc("client.retries")
                self._sleep_backoff(attempt, deadline)
        raise RetryableStorageError(f"cannot reach storage server {self._url}: {last}") from last

    # -- pruner-spec interning ---------------------------------------------------

    _SPEC_DEF = "__spec_def__"
    _SPEC_REF = "__spec_ref__"

    def _spec_wire(self, study_id: int, spec: dict) -> dict:
        """Intern a pruner spec per (connection, study): the full spec
        travels once as ``{__spec_def__: {id, spec}}``, every later fused
        report of the same study sends the ~20-byte ``{__spec_ref__: id}``
        instead.  The server's cache is per-connection, so a re-dialed
        socket starts clean on both sides (see ``_sock``/``_drop_sock``)."""
        ids = getattr(self._local, "spec_ids", None)
        if ids is None:
            ids = self._local.spec_ids = {}
        key = (study_id, json.dumps(spec, sort_keys=True))
        ref = ids.get(key)
        if ref is not None:
            return {self._SPEC_REF: ref}
        ref = len(ids)
        ids[key] = ref
        return {self._SPEC_DEF: {"id": ref, "spec": spec}}

    def _encode_params(self, method: str, params: list) -> list:
        if (
            method == "report_and_prune"
            and len(params) >= 6
            and isinstance(params[4], dict)
            and self._SPEC_DEF not in params[4]
            and self._SPEC_REF not in params[4]
        ):
            params = list(params)
            params[4] = self._spec_wire(params[0], params[4])
        return params

    @staticmethod
    def _is_spec_ref_miss(e: Exception) -> bool:
        return isinstance(e, ValueError) and "pruner spec ref" in str(e)

    def _call(self, method: str, *params: Any) -> Any:
        # per-method RPC latency: measured around the full retry loop, so a
        # re-dialed call's percentiles include what the worker actually waited
        t0 = time.perf_counter() if telemetry.enabled() else 0.0
        try:
            return self._call_timed(method, params)
        finally:
            if telemetry.enabled():
                telemetry.observe(f"client.rpc.{method}", time.perf_counter() - t0)

    def _deadline(self) -> "float | None":
        if self._rpc_deadline is None:
            return None
        return time.monotonic() + self._rpc_deadline

    def _rotate(self) -> None:
        """Advance the shared candidate cursor past the node that just
        refused us, so the next dial starts at its neighbour."""
        if len(self._candidates) > 1:
            self._active = (self._active + 1) % len(self._candidates)

    def _op_id(self) -> str:
        return f"{self._client_uid}:{self._req_id()}"

    def _call_timed(self, method: str, params: tuple) -> Any:
        deadline = self._deadline()
        op_id = self._op_id() if method in _OP_STAMPED else None
        spec_retry = True
        unavailable = 0
        while True:
            encoded = self._encode_params(method, list(params))
            request = {"id": self._req_id(), "method": method, "params": encoded}
            if op_id is not None:
                request["op"] = op_id  # stable across every retransmit
            try:
                response, rich = self._call_raw(
                    request, idempotent=method not in _NON_IDEMPOTENT,
                    deduped=op_id is not None, deadline=deadline,
                )
                return self._unwrap(response, rich)
            except StorageUnavailableError:
                # a not-yet-promoted replica (or mid-failover node) answered:
                # drop the socket, rotate, and retry until the deadline
                unavailable += 1
                self._drop_sock()
                self._rotate()
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                if len(self._candidates) <= 1 and unavailable >= self._retries:
                    raise
                telemetry.inc("client.unavailable_retries")
                self._sleep_backoff(unavailable, deadline)
            except ValueError as e:
                # a spec ref can outlive its server-side cache when the
                # connection is torn between encode and send: resend once
                # with the cache cleared (the full spec travels again)
                if spec_retry and self._is_spec_ref_miss(e):
                    spec_retry = False
                    self._local.spec_ids = {}
                    continue
                raise

    def call_batch(self, calls: list[tuple[str, tuple]]) -> list[Any]:
        """Execute many calls in one round trip (server-side request batching).

        Used by :class:`CachedStorage` to flush buffered writes.  The batch is
        idempotent-retried only if *every* call in it is idempotent; a
        spec-ref cache miss (see ``_spec_wire``) likewise resends the whole
        batch once — every op in a spec-carrying batch is an overwrite, so
        the replay is safe.
        """
        idempotent = all(m not in _NON_IDEMPOTENT for m, _ in calls)
        telemetry.inc("client.batched_ops", len(calls))
        with telemetry.span("client.rpc.call_batch"):
            return self._call_batch_inner(calls, idempotent)

    def _call_batch_inner(self, calls: list[tuple[str, tuple]], idempotent: bool) -> list[Any]:
        deadline = self._deadline()
        # op ids are minted ONCE and survive every resend of the batch: a
        # replayed batch whose first half already executed turns into dedup
        # hits instead of double-executions
        op_ids = [self._op_id() if m in _OP_STAMPED else None for m, _ in calls]
        spec_retry = True
        unavailable = 0
        while True:
            request = []
            for (m, p), op in zip(calls, op_ids):
                r = {
                    "id": self._req_id(),
                    "method": m,
                    "params": self._encode_params(m, list(p)),
                }
                if op is not None:
                    r["op"] = op
                request.append(r)
            try:
                responses, rich = self._call_raw(
                    request, idempotent=idempotent, deduped=True, deadline=deadline,
                )
                return [self._unwrap(r, rich) for r in responses]
            except StorageUnavailableError:
                unavailable += 1
                self._drop_sock()
                self._rotate()
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                if len(self._candidates) <= 1 and unavailable >= self._retries:
                    raise
                telemetry.inc("client.unavailable_retries")
                self._sleep_backoff(unavailable, deadline)
            except ValueError as e:
                if spec_retry and self._is_spec_ref_miss(e):
                    spec_retry = False
                    self._local.spec_ids = {}
                    continue
                raise

    @staticmethod
    def _unwrap(response: dict, rich: bool = False) -> Any:
        if response.get("ok"):
            result = response.get("result")
            # v2 responses decode straight to rich objects; v1 JSON results
            # carry serde tags that unpack() resolves
            return result if rich else unpack(result)
        err = response.get("error") or {}
        cls = _ERROR_TYPES.get(err.get("type", ""), StorageInternalError)
        raise cls(err.get("message", "remote storage error"))

    # -- study -----------------------------------------------------------------

    def create_new_study(self, directions: list[StudyDirection], study_name: str) -> int:
        return self._call("create_new_study", list(directions), study_name)

    def delete_study(self, study_id: int) -> None:
        self._call("delete_study", study_id)

    def get_study_id_from_name(self, study_name: str) -> int:
        return self._call("get_study_id_from_name", study_name)

    def get_study_name_from_id(self, study_id: int) -> str:
        return self._call("get_study_name_from_id", study_id)

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        return self._call("get_study_directions", study_id)

    def get_all_studies(self) -> list[StudySummary]:
        return self._call("get_all_studies")

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._call("set_study_user_attr", study_id, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._call("set_study_system_attr", study_id, key, value)

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        return self._call("get_study_user_attrs", study_id)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        return self._call("get_study_system_attrs", study_id)

    # -- trial -----------------------------------------------------------------

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        return self._call("create_new_trial", study_id, template_trial)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        if n <= 0:
            return []
        if n == 1:
            return [self.create_new_trial(study_id, template_trial)]
        # one native RPC: n trials claimed in a single dispatch (the batched
        # per-trial fallback cost one dispatch per trial inside the frame)
        return self._call("create_new_trials", study_id, int(n), template_trial)

    def set_trial_param(
        self, trial_id: int, param_name: str, param_value_internal: float,
        distribution,
    ) -> None:
        self._call("set_trial_param", trial_id, param_name, float(param_value_internal), distribution)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        vs = [float(v) for v in values] if values is not None else None
        return self._call("set_trial_state_values", trial_id, state, vs)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        self._call("set_trial_intermediate_value", trial_id, int(step), float(intermediate_value))

    def report_and_prune(
        self, study_id: int, trial_id: int, step: int, value: float,
        pruner_spec: dict, direction,
    ) -> bool:
        """Fused report→prune in one frame: the server writes the value and
        evaluates the pruner spec against its own warm peer store.  Safe to
        retry on a torn connection (the write is an overwrite, the decision
        a pure read).  The spec itself is interned per (connection, study)
        — sent once in full, then as a short ref (see ``_spec_wire``)."""
        return bool(
            self._call(
                "report_and_prune", study_id, trial_id, int(step), float(value),
                pruner_spec, direction,
            )
        )

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._call("set_trial_user_attr", trial_id, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._call("set_trial_system_attr", trial_id, key, value)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        return self._call("get_trial", trial_id)

    def get_all_trials(
        self, study_id: int, deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        states_list = list(states) if states is not None else None
        return self._call("get_all_trials", study_id, deepcopy, states_list, since)

    def get_n_trials(self, study_id: int, states: tuple[TrialState, ...] | None = None) -> int:
        states_list = list(states) if states is not None else None
        return self._call("get_n_trials", study_id, states_list)

    def get_trial_id_from_study_and_number(self, study_id: int, number: int) -> int:
        return self._call("get_trial_id_from_study_and_number", study_id, number)

    def get_trials_revision(self, study_id: int) -> int:
        return self._call("get_trials_revision", study_id)

    # -- columnar block fetch (wire protocol v2) ---------------------------------

    def get_observation_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """Finished-trial observations since a revision as raw numpy columns
        (one frame, near-memcpy decode).  Raises ``NotImplementedError`` on a
        v1 connection — callers fall back to ``get_all_trials(since=)``."""
        return self._call("get_observation_block", study_id, int(since))

    def get_iv_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """Intermediate-value curves since a revision as CSR numpy columns.
        Raises ``NotImplementedError`` on a v1 connection."""
        return self._call("get_iv_block", study_id, int(since))

    # -- heartbeat ---------------------------------------------------------------

    def record_heartbeat(self, trial_id: int) -> None:
        self._call("record_heartbeat", trial_id)

    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        return self._call("get_stale_trial_ids", study_id, float(grace_seconds))

    def fail_stale_trials(self, study_id: int, grace_seconds: float) -> list[int]:
        return self._call("fail_stale_trials", study_id, float(grace_seconds))

    def reclaim_stale_trials(
        self, study_id: int, grace_seconds: float, requeue: bool = False
    ) -> list[int]:
        return self._call(
            "reclaim_stale_trials", study_id, float(grace_seconds), bool(requeue)
        )

    # -- telemetry ---------------------------------------------------------------

    def get_trial_events(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """The server-side trial-lifecycle trace (columnar wire dict): events
        from every worker of the fleet, in server execution order."""
        return self._call("get_trial_events", study_id, int(since))

    def get_server_metrics(self) -> dict[str, Any]:
        """The server's always-on metrics surface (see
        ``_RPCServer.server_metrics``): per-method call counts / latency
        percentiles / bytes, active connections, auth failures, cache hits."""
        return self._call("get_server_metrics")

    # -- misc ---------------------------------------------------------------------

    def close(self) -> None:
        """Close this thread's connection (other threads' sockets close on GC)."""
        self._drop_sock()

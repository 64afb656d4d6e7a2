"""Control-plane RPC: a 2-verb (report/get) length-prefixed TCP protocol.

Equivalent capability: the reference's gRPC service with exactly two RPCs
(dlrover/proto/elastic_training.proto:28-31 ``report``/``get``, server
dlrover/python/master/servicer.py:62, client
dlrover/python/elastic_agent/master_client.py:50). We keep the two-verb
design but implement it over a plain threaded TCP socket server with
length-prefixed frames and allowlisted-pickle payloads — no codegen, no
external deps, and the same semantics: ``report`` returns a success ack,
``get`` returns a message.

Frame layout:  [u32 body_len][body]
Body layout :  pickled tuple (verb, node_type, node_id, message[, trace])
Response    :  pickled tuple (ok: bool, message_or_error)

``trace`` is the optional 5th element: the caller's ambient trace
context (``{"trace": ..., "span": ...}``, see common/tracing.py). The
client injects it whenever a span is active; the server adopts it
around dispatch so master-side spans parent under the caller's — one
causal tree across processes. 4-element bodies (older clients, or no
active span) stay fully supported.

The PyTorch port's copy of dlrover_tpu/common/rpc.py.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time

from dlrover_tpu_torch.common import telemetry, tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.framing import (
    recv_frame as _recv_frame,
    send_frame as _send_frame,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.retry import (
    RetryPolicy,
    default_rpc_policy,
    run_with_retry,
)
from dlrover_tpu_torch.common.serialize import deserialize_message, serialize_message

logger = get_logger(__name__)


class RpcService:
    """Interface the server dispatches to (the master servicer implements
    this)."""

    def get(self, node_type: str, node_id: int, message):
        raise NotImplementedError

    def report(self, node_type: str, node_id: int, message) -> bool:
        raise NotImplementedError


# Servicer-side latency buckets: local control-plane RPCs sit in the
# 0.1-10 ms band, so the shared multi-minute DEFAULT_BUCKETS would put
# every observation in the first bucket and p99 would be unresolvable.
SERVER_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        service: RpcService = self.server.service  # type: ignore[attr-defined]
        while True:
            try:
                body = _recv_frame(sock)
            except (ConnectionError, OSError):
                return
            msg_type = ""
            t0 = time.perf_counter()
            verb = ""
            try:
                envelope = deserialize_message(body)
                # 5th element = propagated trace context (older clients
                # send 4); adopt it around dispatch so any span opened
                # while serving parents under the caller's span
                trace_ctx = envelope[4] if len(envelope) > 4 else None
                verb, node_type, node_id, message = envelope[:4]
                msg_type = type(message).__name__
                with tracing.attach(trace_ctx):
                    if verb == "get":
                        result = service.get(node_type, node_id, message)
                        reply = (True, result)
                    elif verb == "report":
                        ok = service.report(node_type, node_id, message)
                        reply = (bool(ok), None)
                    elif verb == "ping":
                        reply = (True, "pong")
                    else:
                        reply = (False, f"unknown verb {verb!r}")
            except Exception as e:  # noqa: BLE001 - fault barrier
                logger.exception("rpc dispatch error")
                reply = (False, f"{type(e).__name__}: {e}")
            # per-verb/message servicer latency: the control-plane
            # surface (master_rpc_p99_ms, joins_per_sec) the bench and
            # obs_report publish, and the baseline the future swarm
            # harness regresses against
            telemetry.observe(
                "master.rpc.seconds",
                time.perf_counter() - t0,
                buckets=SERVER_BUCKETS,
                verb=verb or "?",
                msg=msg_type or "?",
            )
            try:
                _send_frame(sock, serialize_message(reply))
            except (ConnectionError, OSError):
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # Handler threads block in recv on idle client connections; never
    # join them on close or shutdown hangs until every client disconnects.
    block_on_close = False


class RpcServer:
    """Threaded control-plane server. One per master process."""

    def __init__(self, port: int, service: RpcService, host: str = "0.0.0.0"):
        self._server = _Server((host, port), _Handler)
        self._server.service = service  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="dlrover-rpc-server",
            daemon=True,
        )
        self._thread.start()

    def stop(self, grace=None):
        # shutdown() blocks forever if serve_forever never ran — a
        # constructed-but-never-started server must still stop cleanly
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()


class RpcClient:
    """Persistent-connection client with reconnect + retry.

    Mirrors the reference MasterClient retry decorator
    (master_client.py:27 ``retry_grpc_request``), upgraded to the shared
    :class:`~dlrover_tpu_torch.common.retry.RetryPolicy`: exponential backoff
    with full jitter and a per-call total-deadline budget, configured in
    ONE place (`DLROVER_RPC_*` env) instead of per-call-site defaults.
    """

    def __init__(
        self,
        addr: str,
        timeout: float = 30.0,
        policy: RetryPolicy | None = None,
        addr_resolver=None,
    ):
        self._addr = addr
        self._timeout = timeout
        self._policy = policy
        # callable -> current master address (or None/"" to keep the
        # cached one). Consulted on every RE-connect, never on the hot
        # path: a master restarted on a new port after a failover is
        # picked up the moment the old socket dies, instead of the
        # client hammering a dead endpoint forever.
        self._resolver = addr_resolver
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    @property
    def addr(self) -> str:
        return self._addr

    @property
    def policy(self) -> RetryPolicy:
        # resolved lazily so a policy configured via env after client
        # construction (tests, launchers) still takes effect
        return self._policy or default_rpc_policy()

    def _connect(self, timeout: float | None = None):
        if self._resolver is not None:
            try:
                fresh = self._resolver()
            except Exception:  # noqa: BLE001 - a broken resolver must
                # not be worse than no resolver
                fresh = None
            if fresh and fresh != self._addr:
                logger.info(
                    "master address changed: %s -> %s", self._addr, fresh
                )
                self._addr = fresh
        host, _, port = self._addr.rpartition(":")
        sock = socket.create_connection(
            (host or "127.0.0.1", int(port)),
            timeout=self._timeout if timeout is None else timeout,
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def close(self):
        with self._lock:
            self._close_nolock()

    def _close_nolock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _call_once(self, body: bytes, timeout: float | None = None):
        """One round-trip. ``timeout`` (when given) clamps the socket
        timeout for this attempt — the caller passes the remaining
        deadline budget so a single blocking connect/recv cannot
        overshoot the policy's total-deadline by the full transport
        timeout."""
        if timeout is not None:
            timeout = min(self._timeout, max(timeout, 0.05))
        if self._sock is None:
            self._connect(timeout)
        assert self._sock is not None
        if timeout is not None:
            self._sock.settimeout(timeout)
        _send_frame(self._sock, body)
        return deserialize_message(_recv_frame(self._sock))

    def call(
        self,
        verb: str,
        node_type: str,
        node_id: int,
        message,
        retries: int | None = None,
    ):
        """One verb round-trip under the retry policy.

        ``retries`` overrides the policy's attempt count for callers
        that want fail-fast semantics (e.g. best-effort stats reports);
        backoff/jitter/deadline still come from the shared policy.

        The connection lock is held only around the socket round-trip —
        NEVER across backoff sleeps — so one dead master stalls a caller
        thread for at most one attempt, not the whole retry window.
        """
        # trace propagation: captured ONCE per logical call (not per
        # attempt), so a retried/reconnected call keeps the same parent
        # and a master restarted mid-retry still parents its spans
        # correctly — the context lives here, not in master state
        trace_ctx = tracing.wire_context()
        envelope = (
            (verb, node_type, node_id, message)
            if trace_ctx is None
            else (verb, node_type, node_id, message, trace_ctx)
        )
        body = serialize_message(envelope)
        policy = self.policy
        if retries is not None:
            policy = policy.with_attempts(retries)
        msg_type = type(message).__name__
        attempt_counter = iter(range(1 << 30))
        start = time.monotonic()

        def _attempt():
            attempt = next(attempt_counter)
            chaos_point(
                "rpc.send", verb=verb, msg=msg_type, attempt=attempt
            )
            # dlint: allow-blocking(the lock scope IS the contract: held only around one round-trip, released across backoff sleeps — see class docstring)
            with self._lock:
                # budget computed under the lock: time spent queued
                # behind another thread's attempt must come out of THIS
                # attempt's clamp, or the overshoot the clamp exists to
                # prevent comes back under contention
                remaining = policy.deadline - (
                    time.monotonic() - start
                )
                try:
                    ok, payload = self._call_once(
                        body, timeout=remaining
                    )
                except (ConnectionError, OSError):
                    # drop the connection INSIDE this lock hold: after a
                    # timed-out/partial round-trip the stream is out of
                    # sync, and another thread grabbing the lock before
                    # cleanup would read this attempt's late response as
                    # its own reply
                    self._close_nolock()
                    raise
            chaos_point(
                "rpc.recv", verb=verb, msg=msg_type, attempt=attempt
            )
            if not ok and verb == "get":
                raise RuntimeError(f"rpc error: {payload}")
            return ok, payload

        def _drop_connection(_err):
            # covers failures raised OUTSIDE the locked round-trip (an
            # injected chaos drop before send): reconnect next attempt
            with self._lock:
                self._close_nolock()

        result = run_with_retry(
            _attempt,
            policy,
            on_failure=_drop_connection,
            describe=f"rpc to {self._addr}",
            op="rpc",
        )
        # per-method latency, retries included: what the CALLER actually
        # waited (msg-type cardinality is the closed wire-protocol set)
        telemetry.observe(
            "rpc.client.seconds",
            time.monotonic() - start,
            verb=verb,
            msg=msg_type,
        )
        return result

    def get(
        self, node_type: str, node_id: int, message,
        retries: int | None = None,
    ):
        _, payload = self.call("get", node_type, node_id, message, retries)
        return payload

    def report(
        self, node_type: str, node_id: int, message,
        retries: int | None = None,
    ) -> bool:
        ok, _ = self.call("report", node_type, node_id, message, retries)
        return ok

    def ping(self) -> bool:
        try:
            ok, payload = self.call("ping", "", -1, None, retries=1)
            return ok and payload == "pong"
        except Exception:  # noqa: BLE001
            return False


def addr_connectable(addr: str, timeout: float = 3.0) -> bool:
    """The reference telnet-checks the master before use
    (elastic_run.py:258)."""
    host, _, port = addr.rpartition(":")
    try:
        # dlint: allow-chaos(pure reachability probe: a failure IS the signal; faults belong on rpc.send/rpc.recv where retries engage)
        with socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=timeout
        ):
            return True
    except OSError:
        return False


def find_free_port(host: str = "") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]

"""Cross-process IPC primitives: unix-socket services + shared memory.

Equivalent capability: reference dlrover/python/common/multi_process.py —
``SharedLock`` (:234), ``SharedQueue`` (:355), ``SharedDict`` (:462) are
tiny request/response services the *agent* process hosts over unix domain
sockets so *training* processes (which come and go across restarts) can
coordinate; ``SharedMemory`` (:542) is patched to survive the death of the
creating process (resource-tracker unregistration) so checkpoint shards in
shm outlive a crashed worker.

The PyTorch port's copy of dlrover_tpu/common/ipc.py. Its sockets live
in a directory of its own (``DLROVER_TPU_TORCH_SOCKET_DIR``, default
``<tempdir>/dlrover_tpu_torch/sockets``), so the port's services never
answer on the JAX package's sockets.
"""

from __future__ import annotations

import os
import pickle
import queue as _queue
import socket
import socketserver
import tempfile
import threading
import time
from multiprocessing import resource_tracker, shared_memory

from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.framing import recv_frame, send_frame
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

SOCKET_DIR_ENV = "DLROVER_TPU_TORCH_SOCKET_DIR"
JOB_NAME_ENV = "ELASTIC_JOB_NAME"
# the job name a Trainer gave this process (set_default_job_name)
_default_job: str | None = None

# Server-side blocking calls are chunked to this long so a handler thread
# never outlives its client's socket by more than one slice (a blocked
# orphan handler would otherwise steal the item its retry came for).
_MAX_SRV_BLOCK = 5.0


def default_socket_dir() -> str:
    """The port's own directory under the temp dir: a JAX-package agent
    on the same host keeps its sockets elsewhere."""
    return os.path.join(tempfile.gettempdir(), "dlrover_tpu_torch",
                        "sockets")


def job_name() -> str:
    """The job's name, which the port's shm segments carry: the agent's
    ``ELASTIC_JOB_NAME``, else the name a Trainer derived from its output
    dir (:func:`set_default_job_name`), else ``"local"``."""
    return os.environ.get(JOB_NAME_ENV) or _default_job or "local"


def set_default_job_name(name: str | None) -> None:
    global _default_job
    _default_job = name


def _socket_dir() -> str:
    d = os.environ.get(SOCKET_DIR_ENV) or default_socket_dir()
    os.makedirs(d, exist_ok=True)
    return d


def socket_path(kind: str, name: str) -> str:
    return os.path.join(_socket_dir(), f"{kind}_{name}.sock")


def _rpc_over_unix_socket(path: str, request: tuple, timeout: float = 30.0):
    chaos_point("ipc.request", method=request[0] if request else "")
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(path)
        send_frame(sock, pickle.dumps(request))
        return pickle.loads(recv_frame(sock))


class _UnixHandler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        try:
            method, args, kwargs = pickle.loads(recv_frame(sock))
            owner = self.server.owner  # type: ignore[attr-defined]
            try:
                result = (True, getattr(owner, "_srv_" + method)(*args, **kwargs))
            except Exception as e:  # noqa: BLE001
                result = (False, f"{type(e).__name__}: {e}")
            send_frame(sock, pickle.dumps(result))
        except (ConnectionError, OSError):
            pass


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True


class LocalSocketComm:
    """Base for the lock/queue/dict services.

    ``create=True`` (the agent side) hosts the unix-socket server;
    ``create=False`` (the training-process side) sends requests to it.
    """

    KIND = "comm"

    def __init__(self, name: str = "", create: bool = False):
        self.name = name
        self.create = create
        self._path = socket_path(self.KIND, name)
        self._server: _UnixServer | None = None
        if create:
            self._start_server()

    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._server = _UnixServer(self._path, _UnixHandler)
        self._server.owner = self  # type: ignore[attr-defined]
        t = threading.Thread(
            target=self._server.serve_forever,
            name=f"{self.KIND}-{self.name}",
            daemon=True,
        )
        t.start()

    def _request(self, method: str, *args, **kwargs):
        if self.create:
            # Server side calls its own implementation directly.
            return getattr(self, "_srv_" + method)(*args, **kwargs)
        ok, result = _rpc_over_unix_socket(
            self._path, (method, args, kwargs)
        )
        if not ok:
            raise RuntimeError(result)
        return result

    def unlink(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self.create and os.path.exists(self._path):
            try:
                os.unlink(self._path)
            except OSError:
                pass

    def is_available(self) -> bool:
        return os.path.exists(self._path)


class SharedLock(LocalSocketComm):
    """A lock shared between the agent and training processes."""

    KIND = "lock"

    def __init__(self, name: str = "", create: bool = False):
        self._lock = threading.Lock() if create else None
        self._owner_id: str | None = None
        super().__init__(name, create)

    # server-side impls ----------------------------------------------------
    def _srv_acquire(self, blocking: bool = True, owner: str = "") -> bool:
        assert self._lock is not None
        acquired = self._lock.acquire(blocking=blocking)
        if acquired:
            self._owner_id = owner
        return acquired

    def _srv_release(self, owner: str = "", force: bool = False) -> bool:
        assert self._lock is not None
        if not self._lock.locked():
            return False
        # Only the holder may release; ``force`` is for the agent
        # reclaiming the lock after the holder process died.
        if not force and self._owner_id is not None and owner != self._owner_id:
            return False
        self._owner_id = None
        self._lock.release()
        return True

    def _srv_locked(self) -> bool:
        assert self._lock is not None
        return self._lock.locked()

    def _srv_owner(self) -> str | None:
        assert self._lock is not None
        return self._owner_id if self._lock.locked() else None

    # client API -----------------------------------------------------------
    def acquire(self, blocking: bool = True) -> bool:
        return self._request(
            "acquire", blocking=blocking, owner=f"{os.getpid()}"
        )

    def release(self, force: bool = False) -> bool:
        return self._request(
            "release", owner=f"{os.getpid()}", force=force
        )

    def locked(self) -> bool:
        return self._request("locked")

    def owner(self) -> str | None:
        """Pid (as str) of the current holder, or None if unheld."""
        return self._request("owner")


class SharedQueue(LocalSocketComm):
    """A queue shared between the agent and training processes."""

    KIND = "queue"

    def __init__(self, name: str = "", create: bool = False, maxsize: int = 0):
        self._queue: _queue.Queue | None = (
            _queue.Queue(maxsize) if create else None
        )
        super().__init__(name, create)

    _EMPTY = "__dlrover_tpu_torch_queue_empty__"

    def _srv_put(self, obj, block=True, timeout=None):
        assert self._queue is not None
        self._queue.put(obj, block=block, timeout=timeout)
        return True

    def _srv_get(self, block=True, timeout=None):
        # Never block longer than one slice: the client re-polls, so a
        # dead client can't orphan a handler that later eats an item.
        assert self._queue is not None
        if not block:
            timeout = 0.0
        elif timeout is None or timeout > _MAX_SRV_BLOCK:
            timeout = _MAX_SRV_BLOCK
        try:
            if timeout == 0.0:
                return self._queue.get(block=False)
            return self._queue.get(block=True, timeout=timeout)
        except _queue.Empty:
            return self._EMPTY

    def _srv_qsize(self):
        assert self._queue is not None
        return self._queue.qsize()

    def put(self, obj, block: bool = True, timeout: float | None = None):
        return self._request("put", obj, block=block, timeout=timeout)

    def get(self, block: bool = True, timeout: float | None = None):
        """Queue.get semantics: blocks (optionally bounded) and raises
        queue.Empty on timeout/non-blocking miss. Implemented as a client
        poll over short server-side slices."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            slice_timeout = _MAX_SRV_BLOCK if block else 0.0
            if deadline is not None:
                remaining = deadline - time.time()
                if remaining <= 0 and block:
                    raise _queue.Empty
                slice_timeout = max(min(slice_timeout, remaining), 0.0)
            result = self._request(
                "get", block=block, timeout=slice_timeout
            )
            if result != self._EMPTY:
                return result
            if not block:
                raise _queue.Empty
            if deadline is not None and time.time() >= deadline:
                raise _queue.Empty

    def qsize(self) -> int:
        return self._request("qsize")

    def empty(self) -> bool:
        return self.qsize() == 0


class SharedDict(LocalSocketComm):
    """A dict shared between the agent and training processes."""

    KIND = "dict"

    def __init__(self, name: str = "", create: bool = False):
        self._dict: dict | None = {} if create else None
        self._cond = threading.Condition() if create else None
        super().__init__(name, create)

    def _srv_set(self, new_dict: dict):
        assert self._dict is not None and self._cond is not None
        with self._cond:
            self._dict.update(new_dict)
            self._cond.notify_all()
        return True

    def _srv_get(self):
        return dict(self._dict or {})

    def set(self, new_dict: dict):
        return self._request("set", new_dict)

    def get(self) -> dict:
        return self._request("get")


# --------------------------------------------------------------------------
# shared memory that survives the creator's death
# --------------------------------------------------------------------------


class PersistentSharedMemory(shared_memory.SharedMemory):
    """``multiprocessing.shared_memory.SharedMemory`` without the resource
    tracker, so the segment is NOT destroyed when the creating (training)
    process dies — the agent can still flush it to storage after a crash.

    Same trick as the reference's patched SharedMemory
    (multi_process.py:542): unregister from the tracker right after create.
    """

    def __init__(self, name=None, create=False, size=0):
        super().__init__(name=name, create=create, size=size)
        try:
            resource_tracker.unregister(self._name, "shared_memory")
        except Exception:  # noqa: BLE001 - tracker layout differs by ver
            pass

    def close(self):
        try:
            super().close()
        except BufferError:
            # numpy views may still reference the buffer; leave mapping.
            pass

    def unlink(self):
        # The inherited unlink() unregisters from the resource tracker,
        # but __init__ already did — the unmatched unregister makes the
        # tracker process KeyError at interpreter exit. Re-register just
        # before so the pair balances; roll back if the segment is gone.
        try:
            resource_tracker.register(self._name, "shared_memory")
        except Exception:  # noqa: BLE001
            pass
        try:
            super().unlink()
        except FileNotFoundError:
            try:
                resource_tracker.unregister(self._name, "shared_memory")
            except Exception:  # noqa: BLE001
                pass
            raise


def get_or_create_shm(name: str, size: int = 0) -> PersistentSharedMemory:
    """Attach to shm ``name`` if it exists, else create it with ``size``.

    If an existing segment is smaller than ``size``, it is unlinked and
    re-created (state dict grew between steps)."""
    try:
        shm = PersistentSharedMemory(name=name, create=False)
        if size > 0 and shm.size < size:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            shm = PersistentSharedMemory(name=name, create=True, size=size)
            shm.just_created = True
            return shm
        shm.just_created = False
        return shm
    except FileNotFoundError:
        if size <= 0:
            raise
        shm = PersistentSharedMemory(name=name, create=True, size=size)
        shm.just_created = True
        return shm


def wait_for_path(path: str, timeout: float = 60.0, interval=0.1) -> bool:
    """Poll until ``path`` exists. Always checks at least once, so a
    zero/negative timeout degrades to a plain existence probe instead of
    unconditionally returning False for a path that is already there."""
    deadline = time.time() + timeout
    while True:
        if os.path.exists(path):
            return True
        remaining = deadline - time.time()
        if remaining <= 0:
            return False
        time.sleep(min(interval, remaining))

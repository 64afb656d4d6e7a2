"""StepTimer: per-process timing into the shared timing ring.

Equivalent capability: reference atorch/dev/xpu_timer — a native library
that times GEMMs/collectives in the training process and exports them via
shared memory to an out-of-process exporter. TPU redesign: XLA kernels
can't be LD_PRELOAD-hooked, so timing happens at the step/phase level
(wall time around jitted calls, D2H checkpoint copies, data waits) and is
pushed into the libdlrtpu shm ring; the agent's TimerRingExporter drains
and aggregates it (the agent's monitor; the port's comes with the
agent).

The PyTorch port's copy of dlrover_tpu/trainer/timer.py; its ring is
the segment ``dlrtpu_torch_timer_{job}``.
"""

from __future__ import annotations

import contextlib
import os
import time

from dlrover_tpu_torch.common import tracing
from dlrover_tpu_torch.common.ipc import (
    SOCKET_DIR_ENV,
    default_socket_dir,
    get_or_create_shm,
    job_name,
)
from dlrover_tpu_torch.native import TimerRing


class Tag:
    STEP = 1          # one training step (wall)
    DATA_WAIT = 2     # blocked on host input pipeline
    CKPT_SHM = 3      # checkpoint D2H + shm write
    CKPT_PERSIST = 4  # shm -> storage persist
    COMPILE = 5       # jit compilation

    NAMES = {1: "step", 2: "data_wait", 3: "ckpt_shm",
             4: "ckpt_persist", 5: "compile"}


_RING_CAPACITY = 8192
_timer = None


def ring_shm_name() -> str:
    return f"dlrtpu_torch_timer_{job_name()}"


class StepTimer:
    """Pushes timing records into the host-wide shm ring.

    Concurrent pushers are safe via the ring's per-slot seqlocks (native
    path) or an advisory file lock (pure-Python fallback). Creation +
    header init happen under a file lock so an attacher can never map a
    zero-capacity header (which would make the native push divide by
    zero)."""

    def __init__(self):
        import fcntl

        size = TimerRing.ring_bytes(_RING_CAPACITY)
        lock_dir = os.environ.get(SOCKET_DIR_ENV) or os.path.dirname(
            default_socket_dir()
        )
        os.makedirs(lock_dir, exist_ok=True)
        self._lock_path = os.path.join(
            lock_dir, f"{ring_shm_name()}.lock"
        )
        with open(self._lock_path, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                self._shm = get_or_create_shm(ring_shm_name(), size)
                created = getattr(self._shm, "just_created", True)
                self._ring = TimerRing(
                    self._shm.buf, _RING_CAPACITY, init=created,
                    lock_path=self._lock_path,
                )
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def record(self, tag: int, start_ns: int, dur_ns: int):
        self._ring.push(tag, start_ns, dur_ns)

    @contextlib.contextmanager
    def time(self, tag: int):
        """Time a phase into the shm ring AND emit it as a trace span
        (``phase.<tag>``): the ring feeds the out-of-process exporter /
        straggler diagnosis, the span feeds the causal trace view —
        same instant, two consumers."""
        t0 = time.time_ns()
        try:
            with tracing.span(f"phase.{Tag.NAMES.get(tag, tag)}"):
                yield
        finally:
            self._ring.push(tag, t0, time.time_ns() - t0)

    def drain(self, max_records: int = 4096) -> list:
        return self._ring.drain(max_records)

    def close(self):
        self._shm.close()


def get_step_timer() -> StepTimer:
    """Process-wide singleton (attaches to the host ring)."""
    global _timer
    if _timer is None:
        _timer = StepTimer()
    return _timer

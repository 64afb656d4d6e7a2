"""Profiling helpers: ``torch.profiler`` traces + step-window capture.

The PyTorch port's copy of dlrover_tpu/trainer/profiler.py. The JAX
package captures XPlane traces with ``jax.profiler``; the port captures
Kineto windows (CPU activity, and CUDA activity wherever a card is
present) through the profiling plane's backend
(:class:`~dlrover_tpu_torch.common.profiling.TorchProfilerBackend`),
which exports each window as a Chrome trace (``*.pt.trace.json``,
loadable in Perfetto or TensorBoard) and holds the process's one
profiler slot while it records.

Usage in a training loop::

    prof = StepProfiler(log_dir, start_step=10, num_steps=3)
    for step in range(n):
        prof.maybe_start(step)
        state, m = train_step(state, batch, rng)
        prof.maybe_stop(step)

or one-shot::

    with trace("/tmp/prof"):
        train_step(...)
"""

from __future__ import annotations

import contextlib
import os

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Capture a trace of the enclosed block; the device is synchronised
    before the window stops, so nothing still in flight is cut out."""
    from dlrover_tpu_torch.common.profiling import TorchProfilerBackend

    backend = TorchProfilerBackend(device)
    if not backend.start(log_dir):
        raise RuntimeError("profiler busy: another window is recording "
                           "in this process")
    try:
        yield log_dir
    finally:
        backend.stop()
        logger.info("profile trace written to %s", log_dir)


class StepProfiler:
    """Captures a window of training steps (the reference pattern of
    profiling steps [start, start+num) once warmup is done).

    Kineto runs one window per process: where another window (the
    device-time sampler's deep capture) holds the profiler at the start
    step, the window opens at the first step it is free, as it does after
    a resume past the start step."""

    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 3, publish_top_ops: bool = False,
                 forbid_ops: tuple = (), require_ops: tuple = (),
                 device=None):
        self.log_dir = log_dir
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + int(num_steps)
        self.num_steps = int(num_steps)
        self.publish_top_ops = publish_top_ops
        # kernel-name substrings that must NOT appear in the captured
        # window (case-insensitive). Checked in maybe_stop; raises
        # AssertionError listing the offenders.
        self.forbid_ops = tuple(forbid_ops)
        # kernel-name substrings that MUST appear — e.g. the flash
        # kernels on the main path. Checked in maybe_stop; raises
        # AssertionError naming the missing ops.
        self.require_ops = tuple(require_ops)
        self.device = device
        self._backend = None
        self._active = False
        self._done = False

    def maybe_start(self, step: int):
        # >= not ==: a checkpoint resume past the window still profiles,
        # starting at the first available step
        if self._done or self._active or step < self.start_step:
            return
        from dlrover_tpu_torch.common.profiling import TorchProfilerBackend

        backend = TorchProfilerBackend(self.device)
        if not backend.start(self.log_dir):
            return  # the profiler is busy: try again next step
        if step > self.start_step:
            self.stop_step = step + (self.stop_step - self.start_step)
            self.start_step = step
        self._backend = backend
        self._active = True
        logger.info("profiling steps [%d, %d) -> %s",
                    self.start_step, self.stop_step, self.log_dir)

    def maybe_stop(self, step: int, block_on=None):
        """``block_on``: outputs of the last profiled step; the device is
        synchronised before the window stops whatever it holds, so the
        asynchronous launches of the step are all in the window."""
        if not self._active or step < self.stop_step - 1:
            return
        self._backend.stop(block_on=block_on)
        self._backend = None
        self._active = False
        self._done = True
        logger.info("profile window complete: %s", self.log_dir)
        if self.publish_top_ops:
            # divide by the steps actually captured: close() can end
            # the window early (step < stop_step)
            captured = max(
                min(step, self.stop_step - 1) - self.start_step + 1, 1)
            try:
                publish_kernel_stats(
                    self.log_dir, steps=captured)
            except Exception:  # noqa: BLE001 - stats are best-effort
                logger.warning("per-op stats publish failed",
                               exc_info=True)
        if self.forbid_ops:
            self.assert_ops_absent(self.forbid_ops)
        if self.require_ops:
            self.assert_ops_present(self.require_ops)

    def _ops(self) -> list[dict]:
        """Every device kernel of the window; raises where the window
        recorded CUDA activity but holds no CUDA event."""
        from dlrover_tpu_torch.common import trace_summary

        ops = top_ops_from_trace(self.log_dir, k=4096)
        if not ops and "cuda" in trace_summary.window_info(
                self.log_dir).get("activities", ()):
            raise AssertionError(
                f"profile window {self.log_dir} recorded CUDA activity "
                f"but holds no CUDA event")
        return ops

    def assert_ops_absent(self, substrings: tuple) -> int:
        """Raise AssertionError if any profiled kernel name contains one
        of ``substrings``. Vacuously passes when the window holds no
        device kernels because it recorded CPU activity only (the CPU);
        returns the number of kernels inspected so callers can tell
        "verified clean" from "nothing to check". Raises explicitly (not
        via the ``assert`` statement, which ``-O`` strips)."""
        ops = self._ops()
        bad = [
            o for o in ops
            if any(s.lower() in o["op"].lower() for s in substrings)
        ]
        if bad:
            raise AssertionError(
                f"forbidden ops in profile window {self.log_dir}: "
                f"{[(o['op'], o['category']) for o in bad]}"
            )
        return len(ops)

    def assert_ops_present(self, substrings: tuple) -> int:
        """Raise AssertionError unless EVERY substring matches at least
        one profiled kernel name. Vacuously passes on a CPU-only window
        (same contract as :meth:`assert_ops_absent`); returns the number
        of kernels inspected."""
        ops = self._ops()
        if not ops:
            return 0
        missing = [
            s for s in substrings
            if not any(s.lower() in o["op"].lower() for o in ops)
        ]
        if missing:
            raise AssertionError(
                f"required ops missing from profile window "
                f"{self.log_dir}: {missing} "
                f"({len(ops)} ops inspected)"
            )
        return len(ops)

    def close(self):
        if self._active:
            self.maybe_stop(self.stop_step)


def top_ops_from_trace(log_dir: str, k: int = 15,
                       steps: int = 1) -> list[dict]:
    """Top-k device kernels of the newest trace under ``log_dir`` by
    total self time per step: ``[{op, category, self_ms_per_step}]``.

    The online half of xpu_timer's per-kernel attribution — a thin
    delegate to the ONE shared trace reader
    (:mod:`dlrover_tpu_torch.common.trace_summary`), which the
    device-time sampler also consumes."""
    from dlrover_tpu_torch.common import trace_summary

    return trace_summary.top_ops(log_dir, k=k, steps=steps)


def publish_kernel_stats(log_dir: str, k: int = 15, steps: int = 1,
                         out_path: str | None = None) -> list[dict]:
    """Parse + atomically publish top-op stats where the agent's
    Prometheus endpoint picks them up (ConfigPath.KERNEL_METRICS, served
    as ``dlrtpu_kernel_self_ms``)."""
    import json as _json

    from dlrover_tpu_torch.common.constants import ConfigPath

    ops = top_ops_from_trace(log_dir, k=k, steps=steps)
    if not ops:
        return ops
    path = out_path or os.environ.get(
        ConfigPath.ENV_KERNEL_METRICS, ConfigPath.KERNEL_METRICS
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"  # concurrent workers publish too
    with open(tmp, "w") as f:
        _json.dump({"top_ops": ops}, f)
    os.replace(tmp, path)
    logger.info("published %d per-op timings to %s", len(ops), path)
    return ops

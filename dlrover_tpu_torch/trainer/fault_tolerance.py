"""Worker-side hang detection.

Equivalent capability: reference atorch/atorch/fault_tolerance/
hanging_detector.py:86 (`HangingDetector` — training processes report
progress to a store; a monitor decides a relaunch when progress stalls)
and custom_agent.py:19 (local agent acting on the decision).

TPU notes: a hang usually means a stuck collective (ICI/DCN partner
died) or a host-side deadlock — the Python thread here still runs, so a
progress-timestamp watchdog works. The detector reports to the master
(global hang handling: the master's SpeedMonitor + all_running_node_
hanged covers the job level); locally it can run a callback (e.g.
os._exit to trigger the agent's restart-with-rendezvous path).

The PyTorch port's copy of dlrover_tpu/trainer/fault_tolerance.py.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# Started detectors, so resume events (checkpoint restore, rendezvous)
# can reset every stall clock in the process without plumbing detector
# handles through the trainer stack. Weak: a dropped detector must not
# be kept alive by the registry.
_ACTIVE: "weakref.WeakSet[HangingDetector]" = weakref.WeakSet()


def notify_progress_reset(reason: str = ""):
    """Reset the stall clock of every active detector. Call after a
    checkpoint restore or rendezvous resume: wall time passed while no
    step COULD progress, and a restart right after a long restore must
    not be misclassified as a hang."""
    for det in list(_ACTIVE):
        det.reset_progress(reason)


class HangingDetector:
    def __init__(
        self,
        timeout: float = 600.0,
        check_interval: float = 15.0,
        on_hang: Optional[Callable[[], None]] = None,
        master_client=None,
    ):
        self._timeout = timeout
        self._interval = check_interval
        self._on_hang = on_hang
        self._client = master_client
        self._last_progress = time.time()
        self._last_step = -1
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._hang_reported = False

    # ------------------------------------------------------------ report

    def report_progress(self, step: int | None = None):
        """Call from the training loop every step (cheap)."""
        if step is not None:
            if step == self._last_step:
                return
            self._last_step = step
        self._last_progress = time.time()
        self._hang_reported = False

    def reset_progress(self, reason: str = ""):
        """Restart the stall clock WITHOUT claiming a new step — for
        resume events (restore/rendezvous) where elapsed wall time says
        nothing about training progress. Unlike report_progress, the
        step counter is untouched, so the next real step still counts."""
        self._last_progress = time.time()
        self._hang_reported = False
        if reason:
            logger.info("hang-detector clock reset (%s)", reason)

    def is_hanging(self) -> bool:
        return time.time() - self._last_progress > self._timeout

    # ----------------------------------------------------------- monitor

    def start(self):
        if self._thread is not None:
            return
        _ACTIVE.add(self)
        # the monitoring clock starts NOW — construction time may be
        # long before start (model build, compile), and that gap is not
        # a hang
        self.reset_progress()
        self._thread = threading.Thread(
            target=self._loop, name="hang-detector", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
        _ACTIVE.discard(self)

    def _loop(self):
        while not self._stopped.is_set():
            try:
                if self.is_hanging() and not self._hang_reported:
                    self._hang_reported = True
                    stalled = time.time() - self._last_progress
                    logger.error(
                        "no training progress for %.0fs (step %s): "
                        "hang suspected", stalled, self._last_step,
                    )
                    # post-mortem FIRST, report second: the flight
                    # record (last spans/events + every thread's stack,
                    # incl. whatever the main thread is stuck in) is
                    # the evidence; the report/relaunch may destroy it
                    from dlrover_tpu_torch.common import flight

                    flight.dump(
                        "hang-detector",
                        stalled_s=round(stalled, 3),
                        last_step=self._last_step,
                    )
                    if self._client is not None:
                        try:
                            self._client.report_failure(
                                "hang: no progress for "
                                f"{stalled:.0f}s", level="process_error",
                            )
                        except Exception:  # noqa: BLE001
                            pass
                    if self._on_hang is not None:
                        self._on_hang()
            except Exception:  # noqa: BLE001
                logger.exception("hang detector iteration failed")
            self._stopped.wait(self._interval)

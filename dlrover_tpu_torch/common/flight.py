"""Crash-time flight recorder: last spans/events + all-thread stacks.

Equivalent capability: the reference's xpu_timer dumps Python/native
stack traces of a hanging training process on demand; CheckFreq-style
post-mortems show the last thing a process did matters more than the
exit code. Here every process already keeps a bounded ring of its last
~:data:`~dlrover_tpu.common.telemetry.MAX_EVENTS` spans/timeline events
(:mod:`telemetry` + :mod:`tracing`); this module dumps that ring — plus
``faulthandler``-style stacks of every live thread — atomically to
``$DLROVER_TELEMETRY_DIR/flight/`` so a kill, preemption, or hang
leaves a one-file post-mortem.

Triggers:

- **SIGTERM / SIGABRT** (:func:`install`): a preemption or an abort
  dumps before the process dies. The previous handler is chained; with
  no previous handler the default disposition is re-raised so exit
  semantics (and the agent's exit-code taxonomy) are unchanged.
- **chaos kill** (:mod:`~dlrover_tpu.common.chaos` calls :func:`dump`
  right before ``os._exit``): every seeded kill schedule leaves an
  artifact.
- **HangingDetector expiry** (worker-side) and a **received hang
  diagnosis** (agent-side, from ``master/diagnosis.py``): a stuck
  process records what it was doing while it is still stuck.

Dumps are best-effort by construction: no telemetry dir means no dump
(never an error), and a dump failure never takes the dying process's
real exit path with it.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

FLIGHT_SUBDIR = "flight"
FORMAT = 1

_install_lock = threading.Lock()
_installed = False
_prev_handlers: dict[int, object] = {}


def flight_dir(create: bool = False) -> str | None:
    base = os.environ.get(telemetry.ENV_DIR, "")
    if not base:
        return None
    path = os.path.join(base, FLIGHT_SUBDIR)
    if create:
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            return None
    return path


def thread_stacks() -> str:
    """faulthandler-equivalent all-thread Python stacks, as a string.

    ``sys._current_frames`` + ``traceback`` rather than
    ``faulthandler.dump_traceback`` so the result can be embedded in
    the JSON artifact (faulthandler only writes to a raw fd); the
    content is the same per-thread stack listing."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in sorted(sys._current_frames().items()):
        name = names.get(tid, "?")
        chunks.append(f"Thread {tid} ({name}):")
        chunks.append(
            "".join(traceback.format_stack(frame)).rstrip()
        )
        chunks.append("")
    return "\n".join(chunks)


def build_record(snap: dict, reason: str, **extra) -> dict:
    """The ONE flight-record schema, shared by :func:`dump` and the
    deep-capture artifact writer (``profiling.write_capture_artifact``)
    — a field added here (as ``series`` was) lands in both post-mortem
    surfaces instead of silently diverging."""
    return {
        "format": FORMAT,
        "reason": reason,
        "time": time.time(),
        "pid": os.getpid(),
        "source": snap.get("source") or f"pid-{os.getpid()}",
        "role": snap.get("role", ""),
        # the bounded ring IS the flight payload: the last ~4096
        # spans/events of this process, spans included (kind="span")
        "events": snap.get("events", []),
        "events_dropped": snap.get("events_dropped", 0),
        "counters": snap.get("counters", []),
        "gauges": snap.get("gauges", []),
        # the quantitative lead-up, not just the narrative: the
        # newest ~32 points of every local gauge series (step time,
        # MFU, HBM, queue depths) so a post-mortem shows the trend
        # INTO the crash, not only the last value
        "series": telemetry.series_tail(snap.get("series", [])),
        "stacks": thread_stacks(),
        **extra,
    }


def dump(reason: str, _quiet: bool = False, **extra) -> str | None:
    """Write this process's flight record atomically. Returns the path,
    or None when no telemetry dir is configured / the write failed.
    ``_quiet`` is set by the signal handler: no logging from signal
    context (the logging module's locks are as non-reentrant as the
    registry's)."""
    out_dir = flight_dir(create=True)
    if out_dir is None:
        return None
    try:
        # best-effort snapshot: a signal handler runs on the main
        # thread and may have interrupted a registry hook that holds
        # the (non-reentrant) lock — snapshot() would self-deadlock
        snap = telemetry.snapshot_best_effort() or {}
        record = build_record(snap, reason, **extra)
        source = record["source"]
        # one artifact per (process, reason): a later dump for the same
        # reason supersedes (atomic replace), different reasons coexist
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )
        path = os.path.join(
            out_dir, f"flight_{source}.{safe_reason}.json"
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
        if not _quiet:
            # dlint: allow-signal(guarded: the signal path passes _quiet=True, so this never runs from handler context)
            logger.warning(
                "flight recorder dumped (%s): %s", reason, path
            )
        return path
    except Exception:  # noqa: BLE001 - a post-mortem writer must never
        # become the thing that kills (or un-kills) the process
        if not _quiet:
            # dlint: allow-signal(guarded by _quiet — see above)
            logger.warning("flight-recorder dump failed", exc_info=True)
        return None


def list_dumps(base_dir: str | None = None) -> list[str]:
    """Flight artifacts under a telemetry dir (newest first)."""
    if base_dir is None:
        path = flight_dir()
    else:
        path = os.path.join(base_dir, FLIGHT_SUBDIR)
    if not path:
        return []
    try:
        names = [
            os.path.join(path, n)
            for n in os.listdir(path)
            if n.startswith("flight_") and n.endswith(".json")
        ]
    except OSError:
        return []
    names.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    return names


def _handler(signum, frame):  # noqa: ARG001 - signal API
    dump(f"sig{signal.Signals(signum).name.lower()[3:]}", _quiet=True)
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    if prev == signal.SIG_IGN:
        return
    # default disposition: restore it and re-deliver so the exit code
    # (e.g. -SIGTERM, which the agent classifies as "stopped") is
    # exactly what it would have been without us
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install(signals=(signal.SIGTERM, signal.SIGABRT)) -> bool:
    """Install the dump-then-chain signal handlers. Main thread only
    (returns False elsewhere — e.g. agents under test runners);
    idempotent."""
    global _installed
    with _install_lock:
        if _installed:
            return True
        try:
            for sig in signals:
                _prev_handlers[sig] = signal.getsignal(sig)
                signal.signal(sig, _handler)
        except ValueError:  # not the main thread
            return False
        _installed = True
        return True


def uninstall():
    """Restore previous handlers (tests)."""
    global _installed
    with _install_lock:
        if not _installed:
            return
        for sig, prev in _prev_handlers.items():
            try:
                signal.signal(
                    sig, prev if prev is not None else signal.SIG_DFL
                )
            except (ValueError, TypeError):
                pass
        _prev_handlers.clear()
        _installed = False

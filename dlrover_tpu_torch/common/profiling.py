"""Deep profiling plane, worker half: always-on device-time accounting,
anomaly-triggered deep captures, and the unified host+device timeline.

The PyTorch port's copy of dlrover_tpu/common/profiling.py. The JAX
package rides ``jax.profiler``'s XPlane capture; the port rides
``torch.profiler`` (Kineto, with CUPTI on a card) and reads each window
through the Chrome-trace JSON it exports
(:mod:`~dlrover_tpu_torch.common.trace_summary`):

- **Always-on accounting** (:class:`DeviceTimeSampler`): one profiled
  step every ``DLROVER_PROF_SAMPLE_STEPS`` steps, parsed in a
  background thread, published as ``device.optime_ms{category=...}``
  gauges.
- **Op-cost baseline** (:class:`OpCostBaseline`): per
  (model-fingerprint, mesh-shape) persisted category costs, so a
  regression is attributable to a NAMED op category.
- **Deep capture** (:class:`CaptureChannel` + the sampler's capture
  window): the agent relays a master directive into the live worker
  over an atomic file channel; the worker captures N steps of device
  trace plus the flight-recorder payload and writes a self-contained
  artifact including the merged Perfetto timeline.
- **One timeline** (:func:`merge_perfetto`): the span forest and the
  captured CUDA kernels merged into one Chrome-trace/Perfetto JSON;
  Kineto's timestamps are rebased onto the spans' wall clock through
  the trace's ``baseTimeNanoseconds``.

Kineto runs one trace per process, so every window (the sampler's, a
deep capture's, ``StepProfiler``'s) claims the process's one profiler
slot (:func:`claim_profiler`); a window that finds it taken is refused,
as ``jax.profiler.start_trace`` refuses a second trace. The process's
first Kineto start initialises the profiler (CUPTI on a card) and costs
far more than a steady window: the backend flags that window ``cold``,
and the sampler keeps its cost apart (``first_window_cost_s``) instead
of letting the governor read it as the steady cost.

Cost contract: with sampling disabled (``DLROVER_PROF_SAMPLE_STEPS=0``
or no parse path) the per-step hooks are one attribute load and one
``is None``/counter branch. Enabled, the steady-state cost is one
comparison per step plus one capture every N steps, stretched by the
cost governor until it stays under ``DLROVER_PROF_OVERHEAD_PCT`` of the
training wall time. ``torch.profiler`` is imported at the first window,
never when this module is imported.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import queue
import threading
import time

from dlrover_tpu_torch.common import telemetry, trace_summary
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

ENV_SAMPLE_STEPS = "DLROVER_PROF_SAMPLE_STEPS"
ENV_CAPTURE_DIR = "DLROVER_PROF_CAPTURE_DIR"
ENV_BASELINE_PATH = "DLROVER_PROF_BASELINE_PATH"
ENV_REGRESSION_RATIO = "DLROVER_PROF_REGRESSION_RATIO"
# the sampler's steady-state overhead budget as a percent of training
# wall-clock: the cost governor stretches the sampling gap until the
# measured per-window cost amortizes under this. 0 disables governing
# (fixed cadence — tests, short benches).
ENV_OVERHEAD_PCT = "DLROVER_PROF_OVERHEAD_PCT"
DEFAULT_OVERHEAD_PCT = 2.0

DEFAULT_SAMPLE_STEPS = 64
DEFAULT_CAPTURE_STEPS = 2
# the one gauge family the always-on accounting publishes: per-category
# device self time per sampled step (Prometheus family
# ``dlrtpu_device_optime_ms{category=...,source=...}``)
OPTIME_GAUGE = "device.optime_ms"
# a sampled category this much above its stored baseline is a named
# regression (event ``device.optime.regression``), and the baseline
# freezes instead of folding the anomaly in
REGRESSION_RATIO = float(os.environ.get(ENV_REGRESSION_RATIO, "1.3"))
# EWMA weight of a fresh healthy sample folding into the baseline
BASELINE_EWMA = 0.25
# ignore sub-threshold categories when diffing: a 0.01 ms category
# tripling is noise, not an attribution
_MIN_ATTRIB_MS = 0.05

# kernels by name in a parsed window's log line and capture summary
# (nano-350m's step runs ~90 distinct kernels)
DETAIL_KERNELS = 128

_READY_FILE = "capture_ready.json"
_REQUEST_FILE = "capture_request.json"
_ACK_FILE = "capture_ack.json"


def _write_atomic(path: str, payload: dict):
    # every durable write of the profiling plane funnels here: one
    # chaos seam covers the channel files, baselines and artifacts
    chaos_point("prof.write", path=os.path.basename(path))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return None  # torn/absent: poll again


# -------------------------------------------------------------------------
# baseline keying
# -------------------------------------------------------------------------


def _leaf_paths(tree, prefix: str = ""):
    """(path, leaf) of a nested dict/list/tuple, dict keys sorted, each
    path in ``jax.tree_util.keystr``'s form (``['a'][0]``)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_paths(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaf_paths(child, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _dtype_name(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return type(leaf).__name__
    return str(dtype).removeprefix("torch.")


def model_fingerprint(params) -> str:
    """Stable fingerprint of a model's parameter STRUCTURE (leaf paths,
    shapes, dtypes — not values): the baseline key half that survives
    restarts and reshapes of the same model. Over the port's parameter
    dict (``{name: tensor}``, a DTensor by its global shape) it is the
    JAX package's fingerprint of a tree of the same names, shapes and
    dtypes."""
    try:
        desc = [
            (path, tuple(getattr(leaf, "shape", ())), _dtype_name(leaf))
            for path, leaf in _leaf_paths(params)
        ]
    except Exception:  # noqa: BLE001 - odd state still gets a
        # deterministic (if coarser) key
        desc = repr(type(params))
    return hashlib.sha1(
        json.dumps(desc, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def mesh_shape_key(mesh) -> str:
    """The mesh half of the baseline key: axis sizes in axis order
    (``data=2,fsdp=4``) of the port's ``Mesh`` (every axis, 1 on one
    card) or of a ``DeviceMesh`` (its named dims); the device count as
    the fallback."""
    try:
        names = getattr(mesh, "mesh_dim_names", None)
        shape = (dict(zip(names, mesh.shape)) if names
                 else dict(mesh.shape))
        return ",".join(f"{a}={n}" for a, n in shape.items())
    except Exception:  # noqa: BLE001
        try:
            return f"devices={mesh.size()}"
        except Exception:  # noqa: BLE001
            return "devices=?"


class OpCostBaseline:
    """Persisted per-(model-fingerprint, mesh-shape) op-category costs.

    One JSON file, atomically rewritten: ``{key: {"categories":
    {cat: ms}, "samples": n, "updated": t}}``. Updates fold healthy
    samples in with an EWMA; a sample where any significant category
    exceeds ``regression_ratio`` x its baseline FREEZES the baseline
    (the anomaly must stay attributable against the healthy past, not
    erode it)."""

    def __init__(self, path: str, regression_ratio: float = REGRESSION_RATIO):
        self.path = path
        self.regression_ratio = regression_ratio
        self._lock = threading.Lock()
        self._data: dict[str, dict] = {}
        loaded = _read_json(path)
        if isinstance(loaded, dict):
            self._data = loaded

    @staticmethod
    def key(fingerprint: str, mesh_key: str) -> str:
        return f"{fingerprint}|{mesh_key}"

    def get(self, key: str) -> dict | None:
        with self._lock:
            entry = self._data.get(key)
            return dict(entry["categories"]) if entry else None

    def update(self, key: str, categories: dict) -> tuple[dict, bool]:
        """Fold one sample in. Returns ``(baseline_after, regressed)``
        — ``regressed`` True when the sample breached the freeze ratio
        against the stored baseline (which then did NOT move)."""
        categories = {
            k: float(v) for k, v in (categories or {}).items()
        }
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self._data[key] = {
                    "categories": dict(categories),
                    "samples": 1,
                    "updated": time.time(),
                }
                self._persist_locked()
                return dict(categories), False
            base = entry["categories"]
            regressed = any(
                base.get(cat, 0.0) > _MIN_ATTRIB_MS
                and ms > self.regression_ratio * base[cat]
                for cat, ms in categories.items()
                if ms > _MIN_ATTRIB_MS
            )
            if not regressed:
                a = BASELINE_EWMA
                for cat, ms in categories.items():
                    prev = base.get(cat)
                    base[cat] = (
                        ms if prev is None else (1 - a) * prev + a * ms
                    )
                entry["samples"] = int(entry.get("samples", 0)) + 1
                entry["updated"] = time.time()
                self._persist_locked()
            return dict(base), regressed

    def diff(self, key: str, categories: dict) -> list[dict]:
        """Attribution of a sample against the stored baseline, worst
        first: ``[{category, current_ms, baseline_ms, delta_pct}]``.
        Empty when no baseline exists for the key."""
        base = self.get(key)
        if base is None:
            return []
        out = []
        for cat in sorted(set(base) | set(categories or {})):
            cur = float((categories or {}).get(cat, 0.0))
            prev = float(base.get(cat, 0.0))
            if max(cur, prev) <= _MIN_ATTRIB_MS:
                continue
            delta = (
                (cur / prev - 1.0) * 100 if prev > 0 else float("inf")
            )
            out.append({
                "category": cat,
                "current_ms": round(cur, 4),
                "baseline_ms": round(prev, 4),
                "delta_pct": (
                    round(delta, 1) if delta != float("inf") else None
                ),
            })
        out.sort(
            key=lambda d: -(
                d["delta_pct"] if d["delta_pct"] is not None else 1e12
            )
        )
        return out

    def _persist_locked(self):
        try:
            os.makedirs(
                os.path.dirname(self.path) or ".", exist_ok=True
            )
            _write_atomic(self.path, self._data)
        except OSError as e:
            logger.warning("op-cost baseline persist failed: %s", e)


def baseline_from_env(out_dir: str) -> OpCostBaseline:
    """The baseline store at its well-known location:
    ``DLROVER_PROF_BASELINE_PATH`` wins, else the telemetry dir (shared
    across worker incarnations), else ``out_dir``."""
    path = os.environ.get(ENV_BASELINE_PATH, "")
    if not path:
        base = os.environ.get(telemetry.ENV_DIR, "") or out_dir
        path = os.path.join(base, "op_cost_baseline.json")
    return OpCostBaseline(path)


# -------------------------------------------------------------------------
# agent <-> worker capture channel (the reshape-channel idiom)
# -------------------------------------------------------------------------


@dataclasses.dataclass
class CaptureRequest:
    """One deep-capture directive, as handed to the live worker."""

    capture_id: str = ""
    steps: int = DEFAULT_CAPTURE_STEPS
    reason: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: dict) -> "CaptureRequest":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{
            k: v for k, v in payload.items() if k in fields
        })


class CaptureChannel:
    """Both halves of the capture file channel (the agent constructs
    one per local worker; the worker builds one from
    ``DLROVER_PROF_CAPTURE_DIR``). Its files are the JAX package's."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # poll() decision cache: (request-file stat, last_id) whose
        # outcome was "nothing new" — the per-step cost contract is
        # ONE stat, so an already-consumed request must not be
        # re-opened and re-parsed on every subsequent step
        self._seen: tuple | None = None

    # ------------------------------------------------------- worker side

    def mark_ready(self):
        _write_atomic(
            os.path.join(self.directory, _READY_FILE),
            {"pid": os.getpid(), "t": time.time()},
        )

    def poll(self, last_id: str) -> CaptureRequest | None:
        path = os.path.join(self.directory, _REQUEST_FILE)
        try:
            st = os.stat(path)
        except OSError:
            return None
        stamp = (st.st_mtime_ns, st.st_size, last_id)
        if stamp == self._seen:
            return None  # unchanged file, already decided: stat only
        payload = _read_json(path)
        if not payload:
            return None
        req = CaptureRequest.from_json(payload)
        if not req.capture_id or req.capture_id == last_id:
            self._seen = stamp
            return None
        return req

    def ack(self, capture_id: str, ok: bool, artifact: str = "",
            summary: dict | None = None, error: str = ""):
        _write_atomic(
            os.path.join(self.directory, _ACK_FILE),
            {
                "capture_id": capture_id,
                "ok": bool(ok),
                "artifact": artifact,
                "summary": summary or {},
                "error": error,
                "t": time.time(),
            },
        )

    # -------------------------------------------------------- agent side

    def worker_ready(self) -> bool:
        return os.path.exists(
            os.path.join(self.directory, _READY_FILE)
        )

    def signal(self, request: CaptureRequest):
        _write_atomic(
            os.path.join(self.directory, _REQUEST_FILE),
            request.to_json(),
        )

    def read_ack(self, capture_id: str) -> dict | None:
        payload = _read_json(os.path.join(self.directory, _ACK_FILE))
        if payload and payload.get("capture_id") == capture_id:
            return payload
        return None

    def await_ack(
        self, capture_id: str, timeout: float, alive_fn=None,
        poll: float = 0.1,
    ) -> dict | None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            ack = self.read_ack(capture_id)
            if ack is not None:
                return ack
            if alive_fn is not None and not alive_fn():
                return None
            time.sleep(poll)
        return None

    def clear(self):
        for name in (_REQUEST_FILE, _ACK_FILE, _READY_FILE):
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass


def execute_capture(
    directive: dict, channel: CaptureChannel, report_fn,
    timeout: float = 90.0, alive_fn=None,
) -> bool:
    """The agent half of a deep capture: relay the master's directive
    into the live worker over the channel, wait (bounded) for the
    artifact, and report the outcome. ``report_fn(capture_id, ok,
    artifact, summary, error)`` is the master report — factored out so
    the training agent and in-process harnesses run the SAME path."""
    cid = str(directive.get("capture_id", ""))
    if not cid:
        return False
    telemetry.event(
        "prof.capture.dispatch", capture=cid,
        reason=directive.get("reason", ""),
    )
    if not channel.worker_ready():
        report_fn(cid, False, "", {}, "no capture watcher on worker")
        return False
    channel.signal(CaptureRequest(
        capture_id=cid,
        steps=int(directive.get("steps") or DEFAULT_CAPTURE_STEPS),
        reason=str(directive.get("reason", "")),
    ))
    ack = channel.await_ack(cid, timeout, alive_fn=alive_fn)
    if ack is None:
        report_fn(cid, False, "", {}, "capture ack timeout")
        return False
    report_fn(
        cid, bool(ack.get("ok")), ack.get("artifact", ""),
        ack.get("summary") or {}, ack.get("error", ""),
    )
    return bool(ack.get("ok"))


# -------------------------------------------------------------------------
# the profiler seam: one Kineto trace per process
# -------------------------------------------------------------------------

# Kineto's one trace per process is process-wide state, so its slot is
# too: the window holding it, and whether Kineto has started once here
_SLOT_LOCK = threading.Lock()
_SLOT = {"owner": None, "warm": False}


def claim_profiler(owner) -> bool:
    """Take the process's one profiler slot for ``owner``; False while
    another window holds it."""
    with _SLOT_LOCK:
        if _SLOT["owner"] is not None:
            return False
        _SLOT["owner"] = owner
        return True


def release_profiler(owner):
    with _SLOT_LOCK:
        if _SLOT["owner"] is owner:
            _SLOT["owner"] = None


class TorchProfilerBackend:
    """The seam over ``torch.profiler`` (the JAX package's
    ``_JaxProfilerBackend``): ``start(log_dir)`` opens a Kineto window
    with CPU activity, and CUDA activity wherever a card is present;
    ``stop()`` synchronises the device (a window that stops before the
    device finishes holds half a step), stops the window and exports
    its Chrome trace as ``<log_dir>/<host>_<pid>.pt.trace.json``, with
    ``window.json`` beside it (the activities, the wall-clock start and
    stop, the stop's legs). Tests swap in a fake with the same two
    methods.

    After each call, ``last_cold`` (the process's first Kineto start)
    and ``last_stop_legs`` (``sync_s``, ``stop_s``,
    ``export_s``) say what it cost. The stop never asks the profiler for
    its Python event list, whose parse costs time for every event: the
    export is Kineto's own."""

    def __init__(self, device=None):
        self.device = device
        self._prof = None
        self._dir = None
        self._info: dict = {}
        self.last_cold = False
        self.last_stop_legs: dict = {}

    def _cuda(self) -> bool:
        import torch

        if self.device is not None:
            return torch.device(self.device).type == "cuda"
        return torch.cuda.is_available()

    def start(self, log_dir: str) -> bool:
        if not claim_profiler(self):
            logger.warning("profiler start skipped: another window is "
                           "active in this process")
            return False
        try:
            from torch.profiler import ProfilerActivity, profile

            cuda = self._cuda()
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            os.makedirs(log_dir, exist_ok=True)
            prof = profile(activities=activities)
            cold = not _SLOT["warm"]
            start_wall = time.time()
            prof.start()
            _SLOT["warm"] = True
        except Exception as e:  # noqa: BLE001 - a profiler that cannot
            # start must not kill the training step; skip this window
            release_profiler(self)
            logger.warning("profiler start skipped: %s", e)
            return False
        self._prof, self._dir = prof, log_dir
        self._info = {"activities": ["cpu", "cuda"] if cuda else ["cpu"],
                      "start_wall": start_wall, "cold": cold}
        self.last_cold = cold
        return True

    def stop(self, block_on=None):
        prof, log_dir, info = self._prof, self._dir, dict(self._info)
        self._prof = None
        if prof is None:
            return
        try:
            import socket

            import torch

            t0 = time.perf_counter()
            if "cuda" in info["activities"]:
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            prof.stop()
            info["stop_wall"] = time.time()
            t2 = time.perf_counter()
            path = os.path.join(
                log_dir,
                f"{socket.gethostname()}_{os.getpid()}"
                + trace_summary.TRACE_SUFFIX)
            prof.export_chrome_trace(path)
            t3 = time.perf_counter()
            legs = {"sync_s": t1 - t0, "stop_s": t2 - t1,
                    "export_s": t3 - t2}
            info.update(legs)
            _write_atomic(
                os.path.join(log_dir, trace_summary.WINDOW_FILE), info)
            self.last_stop_legs = legs
        finally:
            release_profiler(self)


# -------------------------------------------------------------------------
# the per-step sampler + deep-capture executor (worker side)
# -------------------------------------------------------------------------


class DeviceTimeSampler:
    """Always-on per-step device-time accounting + deep-capture
    execution, driven by the trainer at step boundaries:

    - ``on_step_start(step)`` — may open a capture window (one sampled
      step every ``sample_steps``, or the N steps of a pending deep
      capture picked up from the channel).
    - ``on_step_end(step, dur_s, block_on)`` — closes a finished
      window and hands the trace to the background parse thread; the
      step loop never waits for a parse.

    ``parse_fn(trace_dir, steps) -> {raw_category: ms_per_step}``
    defaults to the shared summarizer over the window's CUDA events;
    when neither it nor a recordable device is available (the CPU),
    SAMPLING disables itself (a window nobody can read as device time
    is overhead for nothing) but deep captures still run. On a card a
    window that holds no CUDA event is a parse failure, logged as one,
    never a CPU-only summary. Each parsed sample is logged as one
    ``device-time sample {...}`` line (categories, top kernels by name
    with their ms and calls).

    **Cost governor**: ``sample_steps`` is the FLOOR of the sampling
    gap. Each window's measured cost (profiler start/stop, the device
    synchronisation and the trace export, all on the step thread) is
    amortized against the EWMA step time, and the next sample is pushed
    out until the steady-state cost stays under ``overhead_pct``. The
    process's first Kineto start (``cold``) is no steady cost: it is
    kept as ``first_window_cost_s`` and re-arms at the floor cadence.
    Deep captures bypass the governor (someone explicitly asked).
    """

    def __init__(
        self,
        out_dir: str,
        sample_steps: int | None = None,
        parse_fn=None,
        baseline: OpCostBaseline | None = None,
        capture_channel: CaptureChannel | None = None,
        backend=None,
        artifact_root: str | None = None,
        overhead_pct: float | None = None,
        device=None,
    ):
        self.out_dir = out_dir
        if sample_steps is None:
            raw = os.environ.get(
                ENV_SAMPLE_STEPS, str(DEFAULT_SAMPLE_STEPS)
            ).strip().lower()
            sample_steps = (
                0 if raw in ("0", "off", "false", "no", "")
                else int(raw)
            )
        self.sample_steps = int(sample_steps)
        self.parse_fn = parse_fn
        self._backend = backend or TorchProfilerBackend(device)
        self.baseline = baseline or baseline_from_env(out_dir)
        self.fingerprint = ""
        self.mesh_key = ""
        if capture_channel is None:
            cdir = os.environ.get(ENV_CAPTURE_DIR, "")
            capture_channel = CaptureChannel(cdir) if cdir else None
        self.channel = capture_channel
        if self.channel is not None:
            self.channel.mark_ready()
        self._artifact_root = artifact_root or os.path.join(
            os.environ.get(telemetry.ENV_DIR, "") or out_dir,
            "captures",
        )
        # sampling is viable only when something can read the window
        # as device time
        self._sampling = self.sample_steps > 0 and (
            parse_fn is not None or trace_summary.toolchain_available()
        )
        if overhead_pct is None:
            overhead_pct = float(
                os.environ.get(ENV_OVERHEAD_PCT,
                               str(DEFAULT_OVERHEAD_PCT))
            )
        self._overhead_frac = max(float(overhead_pct), 0.0) / 100.0
        # governor state: next step a sample is due at, EWMA of
        # untraced step time, last window's measured overhead cost
        self._next_sample = self.sample_steps
        self._step_ewma = 0.0
        self.last_window_cost_s = 0.0
        self.first_window_cost_s = 0.0
        self.last_gap = self.sample_steps
        # the newest sampled windows' costs and legs on the step thread
        self.window_costs: collections.deque = collections.deque(
            maxlen=256)
        self._window: dict | None = None
        self._pending: CaptureRequest | None = None
        self._last_capture_id = ""
        self._sample_seq = 0
        self._sample_failures = 0
        self._emitted_cats: set = set()
        self._queue: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stopped = False

    # ------------------------------------------------------------ context

    def set_context(self, fingerprint: str, mesh_key: str):
        """The baseline key for subsequent samples — refreshed by the
        trainer once per (re)shape, never in the step loop."""
        self.fingerprint = fingerprint
        self.mesh_key = mesh_key

    @property
    def baseline_key(self) -> str:
        return OpCostBaseline.key(self.fingerprint, self.mesh_key)

    @property
    def sampling_enabled(self) -> bool:
        return self._sampling

    @property
    def step_ewma_s(self) -> float:
        """The governor's running estimate of an untraced step's wall
        time — the denominator its overhead budget amortizes against."""
        return self._step_ewma

    # --------------------------------------------------------- step hooks

    def on_step_start(self, step: int):
        if self._stopped:
            return
        if self.channel is not None and self._pending is None:
            req = self.channel.poll(self._last_capture_id)
            if req is not None:
                self._pending = req
                telemetry.event(
                    "prof.capture.begin", capture=req.capture_id,
                    steps=req.steps, reason=req.reason, step=step,
                )
        if self._window is not None:
            return
        if self._pending is not None:
            req = self._pending
            self._pending = None
            self._last_capture_id = req.capture_id
            tdir = os.path.join(
                self._artifact_root, req.capture_id, "trace"
            )
            if self._backend.start(tdir):
                self._window = {
                    "kind": "capture",
                    "dir": tdir,
                    "start_step": step,
                    "steps": max(int(req.steps), 1),
                    "request": req,
                    "t0": time.monotonic(),
                }
            elif self.channel is not None:
                self.channel.ack(
                    req.capture_id, False,
                    error="profiler start failed",
                )
            return
        if self._sampling and step > 0 and step >= self._next_sample:
            tdir = os.path.join(self.out_dir, "sample")
            import shutil

            t_begin = time.perf_counter()
            shutil.rmtree(tdir, ignore_errors=True)
            started = self._backend.start(tdir)
            cost = time.perf_counter() - t_begin
            if started:
                self._window = {
                    "kind": "sample",
                    "dir": tdir,
                    "start_step": step,
                    "steps": 1,
                    "t0": time.monotonic(),
                    "cost_s": cost,
                    "cold": bool(getattr(self._backend, "last_cold",
                                         False)),
                }
            else:
                # a refused start (another trace active) still re-arms
                # at the floor cadence, never a hot retry every step
                self._next_sample = step + self.sample_steps

    def on_step_end(self, step: int, dur_s: float = 0.0, block_on=None):
        win = self._window
        if win is None:
            # untraced steps feed the governor's step-time EWMA (a
            # TRACED step runs under instrumentation and would bias
            # the denominator the overhead is amortized against)
            if dur_s > 0:
                self._step_ewma = (
                    dur_s if self._step_ewma <= 0
                    else 0.9 * self._step_ewma + 0.1 * dur_s
                )
            return
        if step < win["start_step"] + win["steps"] - 1:
            return
        self._window = None
        t_begin = time.perf_counter()
        try:
            self._backend.stop(block_on=block_on)
        except Exception:  # noqa: BLE001 - a stop failure must not
            # take the training step down; the window is simply lost
            logger.warning("profiler stop failed", exc_info=True)
            if win["kind"] == "capture" and self.channel is not None:
                self.channel.ack(
                    win["request"].capture_id, False,
                    error="profiler stop failed",
                )
            return
        finally:
            if win["kind"] == "sample":
                self._govern(
                    step,
                    win.get("cost_s", 0.0)
                    + (time.perf_counter() - t_begin),
                    cold=win.get("cold", False),
                )
        win["wall_s"] = time.monotonic() - win["t0"]
        win["end_step"] = step
        self._ensure_worker()
        self._queue.put(win)

    def _govern(self, step: int, window_cost_s: float, cold: bool = False):
        """Re-arm the next sample so the measured per-window overhead
        amortizes under the budget: gap >= cost / (budget * step_time)
        makes steady-state overhead <= budget by construction. A cold
        window (the process's first Kineto start) re-arms at the floor:
        its one-off cost says nothing of the steady one."""
        self.window_costs.append({
            "step": step, "cost_s": window_cost_s, "cold": cold,
            **getattr(self._backend, "last_stop_legs", {})})
        if cold:
            self.first_window_cost_s = window_cost_s
            gap = self.sample_steps
            telemetry.gauge_set(
                "device.optime.first_window_cost_ms",
                round(window_cost_s * 1e3, 3),
            )
        else:
            self.last_window_cost_s = window_cost_s
            gap = self.sample_steps
            if self._overhead_frac > 0 and self._step_ewma > 0:
                gap = max(gap, int(
                    window_cost_s
                    / (self._overhead_frac * self._step_ewma)
                ) + 1)
            telemetry.gauge_set(
                "device.optime.window_cost_ms",
                round(window_cost_s * 1e3, 3),
            )
        self._next_sample = step + gap
        self.last_gap = gap
        telemetry.gauge_set("device.optime.sample_gap", gap)

    # ----------------------------------------------------- parse worker

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="prof-parse", daemon=True
            )
            self._worker.start()

    def _run(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                if job["kind"] == "sample":
                    self._parse_sample(job)
                else:
                    self._finish_capture(job)
            except Exception:  # noqa: BLE001 - the parse thread must
                # survive a bad trace; a capture failure is acked below
                logger.warning(
                    "profile %s parse failed", job["kind"], exc_info=True
                )
                if job["kind"] == "sample":
                    # a parser that REPEATEDLY cannot parse will not
                    # parse the next sample either: stop paying the
                    # capture overhead. One failure is tolerated —
                    # transient I/O must not turn always-on accounting
                    # off for good.
                    self._sample_failures += 1
                    if self._sample_failures >= 2:
                        self._sampling = False
                        logger.warning(
                            "device-time sampling disabled after %d "
                            "consecutive parse failures",
                            self._sample_failures,
                        )
                elif self.channel is not None:
                    self.channel.ack(
                        job["request"].capture_id, False,
                        error="capture parse/artifact failed",
                    )

    @staticmethod
    def _await_trace(trace_dir: str, timeout: float = 5.0) -> bool:
        """The exported trace is on disk once ``stop`` returns; poll
        (off the step thread) for a backend that writes it late."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if trace_summary.trace_paths(trace_dir):
                return True
            time.sleep(0.05)
        return bool(trace_summary.trace_paths(trace_dir))

    def _parse(self, trace_dir: str, steps: int, detail: dict | None = None
               ) -> dict:
        if self.parse_fn is not None:
            # an injected parser owns its own input contract (it may
            # not read trace files at all — bench stubs, tests)
            return dict(self.parse_fn(trace_dir, steps) or {})
        self._await_trace(trace_dir)
        summary = trace_summary.summarize(trace_dir, steps=steps,
                                          top=DETAIL_KERNELS)
        if summary is None:
            return {}
        if "cuda" in summary["activities"] and not summary["device_events"]:
            raise RuntimeError(
                f"the window in {trace_dir} recorded CUDA activity but "
                "holds no CUDA event")
        if detail is not None:
            detail.update({
                "activities": summary["activities"],
                "device_events": summary["device_events"],
                "top_ops": [
                    {"op": o["op"], "category": o["category"],
                     "ms": round(o["ms_per_step"], 4),
                     "calls": o["occurrences"]}
                    for o in summary["top_ops"]],
            })
        return dict(summary.get("by_category") or {})

    def _parse_sample(self, job: dict):
        detail: dict = {}
        raw = self._parse(job["dir"], job["steps"], detail)
        self._sample_failures = 0
        cats = trace_summary.canonical_breakdown(raw)
        if not cats:
            return
        total = sum(cats.values())
        # a category that vanished from this sample (optimization
        # landed, mesh reshaped) must drop to 0, not freeze at its
        # last value on /metrics forever
        for stale in self._emitted_cats - set(cats):
            telemetry.gauge_set(OPTIME_GAUGE, 0.0, category=stale)
        self._emitted_cats = set(cats)
        for cat, ms in sorted(cats.items()):
            telemetry.gauge_set(OPTIME_GAUGE, ms, category=cat)
        telemetry.gauge_set("device.optime.total_ms", total)
        telemetry.gauge_set(
            "device.optime.sample_step", job["start_step"]
        )
        telemetry.counter_inc("prof.samples")
        self._sample_seq += 1
        if detail:
            logger.info("device-time sample %s", json.dumps({
                "step": job["start_step"], "categories": cats,
                "total_ms": total, **detail}))
        key = self.baseline_key
        base, regressed = self.baseline.update(key, cats)
        if regressed:
            attribution = self.baseline.diff(key, cats)
            worst = attribution[0] if attribution else {}
            telemetry.event(
                "device.optime.regression",
                step=job["start_step"],
                category=worst.get("category", "?"),
                delta_pct=worst.get("delta_pct"),
                baseline_key=key,
            )
            telemetry.counter_inc("prof.regressions")
            logger.warning(
                "device-time regression at step %s: %s",
                job["start_step"], worst,
            )

    def _finish_capture(self, job: dict):
        req: CaptureRequest = job["request"]
        raw = {}
        parse_error = ""
        detail: dict = {}
        try:
            raw = self._parse(job["dir"], job["steps"], detail)
        except Exception as e:  # noqa: BLE001 - the trace + flight
            # payload still ship; attribution is just absent
            parse_error = f"{type(e).__name__}: {e}"[:200]
        cats = trace_summary.canonical_breakdown(raw)
        key = self.baseline_key
        attribution = self.baseline.diff(key, cats) if cats else []
        snap = telemetry.snapshot() or {}
        summary = {
            "capture_id": req.capture_id,
            "reason": req.reason,
            "steps": job["steps"],
            "start_step": job["start_step"],
            "end_step": job["end_step"],
            "wall_s": round(job["wall_s"], 4),
            "baseline_key": key,
            "categories": {
                c: round(v, 4) for c, v in sorted(cats.items())
            },
            "attribution": attribution,
            "parse_error": parse_error,
            "source": snap.get("source", ""),
            # what the window recorded and its kernels by name: present
            # where the summarizer read the trace
            **detail,
        }
        artifact_dir = os.path.join(self._artifact_root, req.capture_id)
        write_capture_artifact(artifact_dir, summary, snap)
        telemetry.event(
            "prof.capture.done", capture=req.capture_id,
            dur=job["wall_s"], artifact=artifact_dir,
        )
        telemetry.counter_inc("prof.captures")
        if self.channel is not None:
            self.channel.ack(
                req.capture_id, True, artifact=artifact_dir,
                summary=summary,
            )

    def close(self):
        self._stopped = True
        if self._window is not None:
            try:
                self._backend.stop()
            except Exception:  # noqa: BLE001 - shutting down anyway
                pass
            self._window = None
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=10)


# -------------------------------------------------------------------------
# capture artifacts + the unified Perfetto timeline
# -------------------------------------------------------------------------


def write_capture_artifact(
    artifact_dir: str, summary: dict, snap: dict,
) -> dict:
    """Write a self-contained capture artifact next to the raw trace:

    - ``summary.json`` — per-category device times + the attribution
      diff vs the stored baseline,
    - ``flight.json`` — the flight-recorder payload (span/event window,
      all-thread stacks, metrics-series tails),
    - ``timeline.perfetto.json`` — host spans and the window's CUDA
      kernels merged into one Chrome-trace/Perfetto timeline.

    NOT signal-safe (lock-taking snapshot, multi-file I/O): crash paths
    keep :func:`flight.dump`. Returns ``{name: path}`` for the written
    files."""
    from dlrover_tpu_torch.common import flight

    os.makedirs(artifact_dir, exist_ok=True)
    out = {}
    out["summary"] = os.path.join(artifact_dir, "summary.json")
    _write_atomic(out["summary"], summary)
    flight_rec = flight.build_record(
        snap, f"capture:{summary.get('reason', '')}"
    )
    out["flight"] = os.path.join(artifact_dir, "flight.json")
    _write_atomic(out["flight"], flight_rec)
    window = None
    if summary.get("wall_s"):
        end = flight_rec["time"]
        window = (end - float(summary["wall_s"]), end)
    dev_events, base_s = device_trace(os.path.join(artifact_dir, "trace"))
    merged = merge_perfetto(
        snap.get("events", []),
        device_categories=summary.get("categories"),
        device_window=window,
        device_trace_events=dev_events,
        device_time_base_s=base_s,
    )
    out["perfetto"] = os.path.join(
        artifact_dir, "timeline.perfetto.json"
    )
    _write_atomic(out["perfetto"], merged)
    return out


def device_trace(trace_dir: str) -> tuple[list | None, float | None]:
    """The window's device events (kernels, copies, fills) from the
    exported Chrome trace, with Kineto's time base in wall-clock
    seconds; ``(None, None)`` when there is no trace or it holds no
    device event (a CPU-only window) — the merge then falls back to the
    category summary rendered as proportional slices."""
    paths = trace_summary.trace_paths(trace_dir)
    if not paths:
        return None, None
    try:
        trace = trace_summary.load_trace(paths[-1])
    except (OSError, ValueError):
        logger.warning("unreadable trace %s", paths[-1], exc_info=True)
        return None, None
    events = trace_summary.device_events(trace)
    if not events:
        return None, None
    return events, trace_summary.trace_base_s(trace)


def merge_perfetto(
    events,
    device_categories: dict | None = None,
    device_window: tuple | None = None,
    device_trace_events: list | None = None,
    device_time_base_s: float | None = None,
) -> dict:
    """Merge a (host) telemetry timeline with captured device time into
    ONE Chrome-trace/Perfetto JSON.

    - Host side: every ``span`` event becomes a complete slice on its
      source's track (other ``dur``-carrying events too; instantaneous
      events become instants).
    - Device side: the real per-kernel timeline where the window held
      one (``device_trace_events``), else the per-category accounting
      rendered as proportional slices across the capture window.

    Timestamps are wall-clock microseconds rebased to the earliest
    event so Perfetto's UI opens at t=0. Device events carry their own
    time base: with ``device_time_base_s`` (Kineto's
    ``baseTimeNanoseconds``, in seconds) each lands at its own wall
    time; without it the earliest is anchored at the capture window's
    start (else at the host t0), as the JAX package does for xprof's.
    """
    events = list(events or ())
    starts = []
    for ev in events:
        t = float(ev.get("t", 0.0))
        dur = float(ev.get("dur") or 0.0)
        starts.append(t - dur)
    if device_window:
        starts.append(float(device_window[0]))
    dev_ts = [
        float(ev["ts"]) for ev in device_trace_events or ()
        if "ts" in ev
    ]
    if device_time_base_s is not None and dev_ts:
        starts.append(device_time_base_s + min(dev_ts) / 1e6)
    t0 = min(starts) if starts else 0.0

    pids: dict[str, int] = {}

    def pid_of(source: str) -> int:
        if source not in pids:
            pids[source] = len(pids) + 1
        return pids[source]

    trace: list[dict] = []
    for ev in events:
        source = str(ev.get("source", "") or "host")
        pid = pid_of(source)
        t = float(ev.get("t", 0.0))
        dur = float(ev.get("dur") or 0.0)
        name = (
            str(ev.get("name"))
            if ev.get("kind") == "span" and ev.get("name")
            else str(ev.get("kind", "event"))
        )
        args = {
            k: v for k, v in ev.items()
            if k not in ("t", "mono", "seq", "source", "kind", "dur")
            and isinstance(v, (str, int, float, bool))
        }
        if dur > 0:
            trace.append({
                "ph": "X",
                "name": name,
                "cat": "host",
                "pid": pid,
                "tid": 1,
                "ts": round((t - dur - t0) * 1e6, 1),
                "dur": round(dur * 1e6, 1),
                "args": args,
            })
        else:
            trace.append({
                "ph": "i",
                "s": "p",
                "name": name,
                "cat": "host",
                "pid": pid,
                "tid": 1,
                "ts": round((t - t0) * 1e6, 1),
                "args": args,
            })
    device_pid = len(pids) + 1
    if device_trace_events:
        # the real device timeline: keep its internal tids (CUDA
        # streams), re-home it onto the device track's pid, and REBASE
        # its timestamps onto the host timeline
        if device_time_base_s is not None:
            offset = (device_time_base_s - t0) * 1e6
        else:
            dev_min = min(dev_ts) if dev_ts else 0.0
            anchor_us = (
                (float(device_window[0]) - t0) * 1e6
                if device_window else 0.0
            )
            offset = anchor_us - dev_min
        for ev in device_trace_events:
            ev = dict(ev)
            ev["pid"] = device_pid
            ev.setdefault("cat", "device")
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) + offset, 1)
            trace.append(ev)
    elif device_categories:
        if device_window:
            w0, w1 = float(device_window[0]), float(device_window[1])
        else:
            w0 = t0
            w1 = t0 + sum(device_categories.values()) / 1e3
        span = max(w1 - w0, 1e-6)
        total = sum(device_categories.values()) or 1.0
        cursor = w0
        for cat, ms in sorted(
            device_categories.items(), key=lambda kv: -kv[1]
        ):
            frac = ms / total
            trace.append({
                "ph": "X",
                "name": cat,
                "cat": "device",
                "pid": device_pid,
                "tid": 1,
                "ts": round((cursor - t0) * 1e6, 1),
                "dur": round(span * frac * 1e6, 1),
                "args": {"self_ms_per_step": round(ms, 4)},
            })
            cursor += span * frac
    for source, pid in pids.items():
        trace.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": source},
        })
    trace.append({
        "ph": "M", "name": "process_name", "pid": device_pid,
        "args": {"name": "device"},
    })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}

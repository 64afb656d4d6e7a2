"""Shared trace summarizer of the port: ONE reader of a captured
``torch.profiler`` window.

The port's copy of dlrover_tpu/common/trace_summary.py. The JAX package
walks xprof's ``hlo_stats`` table of an XPlane trace; the port reads the
Chrome-trace JSON that ``torch.profiler`` exports (``*.pt.trace.json``)
and sums the DEVICE events of the window: kernels (``cat: kernel``),
copies (``gpu_memcpy``) and fills (``gpu_memset``), each by its name.
Host-side events (CPU ops, CUDA runtime calls, annotations) are never
counted as device time. The sampler (``common/profiling.py``), the
agent's per-op export (``trainer/profiler.py``) and the capture artifact
all read a window through this module.

It is also the one place that knows the **canonical op-category
buckets** of ``device.optime_ms{category=...}``, the twelve names of the
JAX package: matmul, collective-permute, all-gather, reduce-scatter,
all-reduce, all-to-all, fusion, convolution, infeed-outfeed, copy, host,
other. A baseline keys on them, and so do the master and the HTTP plane.

:func:`canonical_category` maps a raw string to its bucket by substring,
first match wins. The rules hold xprof's category strings to the JAX
package's buckets and add what CUDA's kernel names need:

- NCCL names its collectives without hyphens or spaces
  (``ncclDevKernel_AllGather_RING_LL``, ``..._ReduceScatter_...``,
  ``..._AllReduce_...``, ``ncclDevKernel_SendRecv``): ``allgather``,
  ``reducescatter``, ``allreduce`` and ``alltoall`` go to their
  collectives and ``sendrecv`` (the P2P ring of a ring attention) to
  collective-permute, all before the ``reduce`` of fusion; any other NCCL
  kernel (``Broadcast``, ``Reduce``) is ``other``.
- cuDNN's convolutions are implicit GEMMs (``..._fprop_implicit_gemm``,
  ``dgrad``, ``wgrad``): convolution, before matmul's ``gemm``.
- cuBLAS's GEMMs: ``gemm``, ``gemv``, ``nvjet_*`` (Hopper's cuBLASLt
  kernels, whose names hold no ``gemm``), ``splitKreduce`` (a split-K
  GEMM's reduction) and any other ``cublas`` kernel are matmul.
- ``Memcpy HtoD/DtoH/DtoD`` and ``Memset`` are copy.
- a dtype ``convert`` is fusion (elementwise), not convolution.
- the port's own kernels: the attention kernels K1, K3, K4 and K9-K14
  (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``, their ``_heads``
  and ``flash_ring_*`` forms) are tensor-core loops and count as matmul;
  K1's rope pre-pass ``flash_fwd_rope_k`` and K2
  ``flash_bwd_preprocess`` (a row sum) are fusion, and so are K5/K6
  (``quantize_int8``, ``dequantize_int8``), K7/K8 (``fused_adamw*``)
  and PyTorch's ``multi_tensor_apply`` optimizer kernels.

``torch.profiler`` is imported only where a window is read or recorded,
never when this module is imported.
"""

from __future__ import annotations

import glob
import json
import os

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# canonical category buckets, coarsest-useful granularity for per-step
# accounting and baselines: the JAX package's names exactly
CANONICAL_CATEGORIES = (
    "matmul",
    "collective-permute",
    "all-gather",
    "reduce-scatter",
    "all-reduce",
    "all-to-all",
    "fusion",
    "convolution",
    "infeed-outfeed",
    "copy",
    "host",
    "other",
)

# substring -> canonical bucket, checked in order (first match wins:
# "all-gather-fusion" must land in all-gather, not fusion)
_CATEGORY_RULES = (
    (("collective-permute", "collective permute", "sendrecv"),
     "collective-permute"),
    (("all-gather", "all gather", "allgather"), "all-gather"),
    (("reduce-scatter", "reduce scatter", "reducescatter"),
     "reduce-scatter"),
    (("all-reduce", "all reduce", "cross-replica-sum", "allreduce"),
     "all-reduce"),
    (("all-to-all", "all to all", "alltoall"), "all-to-all"),
    (("nccl",), "other"),
    (("fprop", "dgrad", "wgrad", "implicit_gemm"), "convolution"),
    (("flash_fwd_rope", "flash_bwd_preprocess"), "fusion"),
    (("dot", "matmul", "gemm", "einsum", "gemv", "nvjet", "splitkreduce",
      "cublas", "flash_"), "matmul"),
    (("convert",), "fusion"),
    (("conv",), "convolution"),
    (("infeed", "outfeed"), "infeed-outfeed"),
    (("copy", "transpose", "reshape", "memcpy", "memset"), "copy"),
    (("host", "callback", "stall", "idle"), "host"),
    (("fusion", "loop", "elementwise", "reduce", "quantize", "adamw",
      "multi_tensor"), "fusion"),
)

# the Chrome-trace categories of the events the device itself ran
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json"
# written by the profiler backend beside each trace: what it recorded
WINDOW_FILE = "window.json"


def canonical_category(raw: str) -> str:
    """Map a raw category string or a CUDA kernel name to its bucket."""
    low = (raw or "").lower()
    for needles, bucket in _CATEGORY_RULES:
        if any(n in low for n in needles):
            return bucket
    return "other"


def canonical_breakdown(by_category: dict) -> dict:
    """Collapse a raw ``{category: ms}`` map onto the canonical
    buckets (summing raw categories that share a bucket)."""
    out: dict[str, float] = {}
    for raw, ms in (by_category or {}).items():
        bucket = canonical_category(raw)
        out[bucket] = out.get(bucket, 0.0) + float(ms)
    return out


_TOOLCHAIN: bool | None = None


def toolchain_available() -> bool:
    """Whether ``torch.profiler`` can record CUDA activity here (probed
    once): a CUDA build whose profiler supports the CUDA activity, and a
    card. On the CPU it is False; a window recorded there holds CPU
    activity only, and its summary says so."""
    global _TOOLCHAIN
    if _TOOLCHAIN is None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, supported_activities

            _TOOLCHAIN = bool(
                ProfilerActivity.CUDA in supported_activities()
                and torch.cuda.is_available())
        except Exception:  # noqa: BLE001 - absent OR broken both mean
            # "no device recording here"; the sampler must not crash a
            # training step over a half-installed profiler
            _TOOLCHAIN = False
    return _TOOLCHAIN


def trace_paths(trace_dir: str) -> list[str]:
    """Every ``*.pt.trace.json`` under ``trace_dir``, oldest-first."""
    return sorted(glob.glob(
        os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True
    ))


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def window_info(trace_dir: str) -> dict:
    """The backend's record of a window (``activities``, its wall-clock
    start and stop), or ``{}`` where none was written."""
    try:
        with open(os.path.join(trace_dir, WINDOW_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def device_events(trace: dict) -> list[dict]:
    """The complete (``ph: X``) events the device ran, in trace order."""
    return [
        ev for ev in trace.get("traceEvents", ())
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_EVENT_CATS
    ]


def trace_base_s(trace: dict) -> float | None:
    """Kineto's time base in wall-clock seconds: an event's wall time is
    this plus its ``ts`` in microseconds."""
    base = trace.get("baseTimeNanoseconds")
    return float(base) / 1e9 if base is not None else None


def op_table(paths) -> list[dict]:
    """Per-(category, kernel) device totals of the traces at ``paths``:
    ``[{category, op, self_us, occurrences}]``, longest first."""
    agg: dict[tuple, list] = {}
    for path in paths:
        for ev in device_events(load_trace(path)):
            name = str(ev.get("name", ""))
            key = (canonical_category(name), name)
            entry = agg.setdefault(key, [0.0, 0])
            entry[0] += float(ev.get("dur") or 0.0)
            entry[1] += 1
    return [
        {
            "category": cat,
            "op": name,
            "self_us": t,
            "occurrences": occ,
        }
        for (cat, name), (t, occ) in sorted(
            agg.items(), key=lambda kv: -kv[1][0]
        )
    ]


def summarize(trace_dir: str, steps: int = 1, top: int = 45) -> dict | None:
    """Per-category/per-kernel device-time summary of every trace under
    ``trace_dir``. Returns None when no trace file exists.

    ``activities`` says what the window recorded (``["cpu"]`` on the
    CPU, ``["cpu", "cuda"]`` with a card) and ``device_events`` how many
    device events it held: a CPU-only window reports no device time at
    all, never its host ops as device time. The categories are already
    canonical, so ``by_category`` and ``by_canonical_category`` agree."""
    paths = trace_paths(trace_dir)
    if not paths:
        return None
    ops = op_table(paths)
    steps = max(int(steps), 1)
    bycat: dict[str, float] = {}
    for o in ops:
        bycat[o["category"]] = bycat.get(o["category"], 0.0) + o["self_us"]
    tot = sum(bycat.values())
    activities = window_info(trace_dir).get("activities") or (
        ["cpu", "cuda"] if ops else ["cpu"])
    return {
        "trace_dir": trace_dir,
        "steps": steps,
        "num_traces": len(paths),
        "activities": list(activities),
        "device_events": sum(o["occurrences"] for o in ops),
        "total_ms_per_step": tot / steps / 1e3,
        "by_category": {
            cat: t / steps / 1e3 for cat, t in bycat.items()
        },
        "by_canonical_category": canonical_breakdown({
            cat: t / steps / 1e3 for cat, t in bycat.items()
        }),
        "top_ops": [
            {
                "category": o["category"],
                "op": o["op"],
                "ms_per_step": o["self_us"] / steps / 1e3,
                "occurrences": o["occurrences"],
            }
            for o in ops[:top]
        ],
    }


def top_ops(log_dir: str, k: int = 15, steps: int = 1) -> list[dict]:
    """Top-k device kernels of the NEWEST trace under ``log_dir`` by
    self time, per profiled step: ``[{op, category, self_ms_per_step}]``.
    Best-effort (``[]`` on a missing or unreadable trace): this is the
    online agent-export path, where a parse failure must never take the
    caller down."""
    paths = trace_paths(log_dir)
    if not paths:
        return []
    try:
        ops = op_table([paths[-1]])
    except Exception:  # noqa: BLE001 - torn or truncated trace
        logger.warning("unreadable trace %s; no per-op stats", paths[-1],
                       exc_info=True)
        return []
    return [
        {
            "op": o["op"],
            "category": o["category"],
            "self_ms_per_step": round(
                o["self_us"] / max(steps, 1) / 1e3, 4
            ),
        }
        for o in ops[:k]
    ]


def render(summary: dict) -> str:
    """Human rendering of a :func:`summarize` payload (the CLI view)."""
    lines = [
        f"total self time {summary['total_ms_per_step']:.1f} ms/step "
        f"({summary['num_traces']} trace file(s), "
        f"{summary['steps']} step(s))",
        "",
        "=== by category ===",
    ]
    if "cuda" not in summary.get("activities", ("cuda",)):
        lines.insert(1, "(CPU activity only: no device time recorded)")
    for cat, ms in sorted(
        summary["by_category"].items(), key=lambda kv: -kv[1]
    ):
        lines.append(f"{ms:8.2f} ms/step  {cat}")
    lines.append("")
    lines.append(f"=== top {len(summary['top_ops'])} ops ===")
    for op in summary["top_ops"]:
        lines.append(
            f"{op['ms_per_step']:8.3f} ms/step  x{op['occurrences']:4d} "
            f"{op['category']:22s} {op['op'][:80]}"
        )
    return "\n".join(lines)

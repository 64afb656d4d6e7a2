"""Pluggable brain optimization algorithms.

Equivalent capability: reference dlrover/go/brain/pkg/optimizer/
implementation/optalgorithm/*.go — PS cold create, init-adjust, OOM,
worker create/running resource. Each algorithm is a function
``(store, request) -> plan dict | None`` registered by name; the TPU
set covers SPMD worker jobs:

- ``cold_create``: size a brand-new job from similar historical jobs
  (median of their last-known worker_count / memory).
- ``worker_resource``: running-job memory right-sizing from this job's
  own usage records (peak * headroom).
- ``oom_memory``: multiply memory after an OOM event.
- ``worker_count``: the largest historical worker count that still
  scales efficiently (per-worker throughput above a floor relative to
  the smallest measured count).

The PyTorch port's copy of dlrover_tpu/brain/algorithms.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

import statistics

from dlrover_tpu_torch.brain.datastore import MetricsStore
from dlrover_tpu_torch.brain.messages import OptimizeRequest

_ALGORITHMS: dict = {}


def register(name: str):
    def deco(fn):
        _ALGORITHMS[name] = fn
        return fn

    return deco


def get_algorithm(name: str):
    return _ALGORITHMS.get(name)


def algorithm_names() -> list[str]:
    return sorted(_ALGORITHMS)


@register("cold_create")
def optimize_cold_create(store: MetricsStore, req: OptimizeRequest):
    histories = store.similar_job_records(req.job_name)
    counts, mems = [], []
    for records in histories:
        if not records:
            continue
        latest = records[0]
        if latest.get("worker_count"):
            counts.append(int(latest["worker_count"]))
        if latest.get("used_memory_mb"):
            mems.append(float(latest["used_memory_mb"]))
    if not counts and not mems:
        return None
    plan = {}
    if counts:
        plan["worker_count"] = int(statistics.median(counts))
    if mems:
        plan["memory_mb"] = int(statistics.median(mems) * 1.3)
    return plan


def _runtime_samples(records: list[dict]) -> list[dict]:
    """Oldest-first JobRuntimeInfo-style samples embedded in records
    (reporters attach them under ``runtime``; records come newest-first
    from the store)."""
    return [r["runtime"] for r in reversed(records) if r.get("runtime")]


def _int_map(value) -> dict:
    return {int(k): float(v) for k, v in (value or {}).items()}


@register("worker_resource")
def optimize_worker_resource(store: MetricsStore, req: OptimizeRequest):
    records = store.job_records(req.job_uuid, limit=100)
    samples = _runtime_samples(records)
    if samples:
        # deep path: the reference's windowed decision (speed state,
        # singularity filtering, idle/exhausted-PS replica moves);
        # a None verdict falls THROUGH to the legacy heuristic
        from dlrover_tpu_torch.brain.runtime_opt import (
            optimize_worker_resource_windowed,
        )

        plan = optimize_worker_resource_windowed(
            samples, _int_map(req.config.get("ps_cpus")), req.config
        )
        if plan is not None:
            return plan
    mems = [
        float(r["used_memory_mb"]) for r in records
        if r.get("used_memory_mb")
    ]
    if not mems:
        return None
    peak = max(mems)
    headroom = float(req.config.get("headroom", 1.4))
    return {"memory_mb": int(peak * headroom)}


@register("oom_memory")
def optimize_oom_memory(store: MetricsStore, req: OptimizeRequest):
    current = float(req.config.get("memory_mb", 0))
    if current <= 0:
        records = store.job_records(req.job_uuid, limit=10)
        mems = [
            float(r["used_memory_mb"]) for r in records
            if r.get("used_memory_mb")
        ]
        if not mems:
            return None
        current = max(mems)
    factor = float(req.config.get("factor", 2.0))
    return {"memory_mb": int(current * factor)}


@register("worker_create_oom")
def optimize_worker_create_oom(store: MetricsStore, req: OptimizeRequest):
    """First-worker sizing for a job whose HISTORY contains OOMs
    (reference optimize_job_worker_create_oom_resource.go): start the
    new run at the historical peak memory times an OOM margin, with a
    minimum increase over the last OOM'd allocation — distinct from
    the runtime ``oom_memory`` doubling, which reacts to an OOM in the
    CURRENT run.
    """
    margin = float(req.config.get("oom_margin_percent", 0.2))
    min_increase = float(req.config.get("min_increase_mb", 1024))
    histories = store.similar_job_records(req.job_name)
    peak = 0.0
    oom_alloc = 0.0
    saw_oom = False
    for records in histories:
        for r in records:
            if r.get("used_memory_mb"):
                peak = max(peak, float(r["used_memory_mb"]))
            if r.get("oom"):
                saw_oom = True
                if r.get("memory_mb"):
                    oom_alloc = max(oom_alloc, float(r["memory_mb"]))
    if not saw_oom or peak <= 0:
        return None
    target = max(peak * (1.0 + margin), oom_alloc + min_increase)
    return {"memory_mb": int(target)}


@register("worker_count")
def optimize_worker_count(store: MetricsStore, req: OptimizeRequest,
                          min_efficiency: float = 0.7):
    """Largest historical worker count that still scales efficiently.

    Picking max aggregate speed would always choose the biggest count
    ever tried; picking max per-worker speed always chooses the
    smallest. The useful answer is the largest count whose per-worker
    throughput stays >= ``min_efficiency`` of the per-worker throughput
    at the smallest measured count (configurable via
    ``config["min_efficiency"]``)."""
    records = store.job_records(req.job_uuid, limit=500)
    if not records:
        records = [
            r for recs in store.similar_job_records(req.job_name)
            for r in recs
        ]
    by_count: dict[int, list[float]] = {}
    for r in records:
        count, speed = r.get("worker_count"), r.get("speed")
        if count and speed:
            by_count.setdefault(int(count), []).append(float(speed))
    if not by_count:
        return None
    min_eff = float(req.config.get("min_efficiency", min_efficiency))
    per_worker = {
        c: statistics.mean(speeds) / c for c, speeds in by_count.items()
    }
    base = per_worker[min(per_worker)]
    if base <= 0:
        return None
    efficient = [
        c for c, pw in per_worker.items() if pw >= min_eff * base
    ]
    if not efficient:
        return None
    return {"worker_count": max(efficient)}


@register("hot_ps")
def optimize_hot_ps(store: MetricsStore, req: OptimizeRequest):
    """Detect hot nodes and plan per-node resource adjustments.

    Reference optimize_job_hot_ps_resource.go: PS pods whose CPU
    utilisation or memory crosses the hot thresholds get their CPU
    extrapolated to the target worker count and memory bumped by a fixed
    adjustment. TPU analogue: "nodes" are sparse/data hosts; records
    carry per-node stats under ``nodes: [{node_id, cpu_percent,
    used_memory_mb}]``."""
    records = store.job_records(req.job_uuid, limit=20)
    samples = _runtime_samples(records)
    if samples:
        from dlrover_tpu_torch.brain.runtime_opt import optimize_hot_ps_windowed

        plan = optimize_hot_ps_windowed(
            samples,
            _int_map(req.config.get("ps_cpus")),
            _int_map(req.config.get("ps_memory")),
            req.config,
        )
        if plan is not None:
            return plan
    nodes = None
    for r in records:
        if r.get("nodes"):
            nodes = r["nodes"]
            break
    if not nodes:
        return None
    cpu_hot = float(req.config.get("hot_cpu_threshold", 90.0))
    mem_hot = float(req.config.get("hot_memory_threshold_mb", 0))
    target_workers = int(req.config.get("target_worker_count", 0))
    mem_adjust = int(req.config.get("memory_adjust_mb", 4096))
    current_workers = int(
        req.config.get("worker_count")
        or next(
            (r["worker_count"] for r in records
             if r.get("worker_count")), 0,
        )
        or len(nodes)
    )
    adjustments = {}
    for node in nodes:
        node_id = node.get("node_id")
        cpu = float(node.get("cpu_percent", 0.0))
        mem = float(node.get("used_memory_mb", 0.0))
        plan = {}
        if cpu >= cpu_hot and current_workers > 0:
            scale = (
                target_workers / current_workers
                if target_workers > 0 else 1.5
            )
            plan["cpu_percent_target"] = min(cpu * scale, 100.0 * 32)
        if mem_hot and mem >= mem_hot:
            plan["memory_mb"] = int(mem + mem_adjust)
        if plan:
            adjustments[str(node_id)] = plan
    if not adjustments:
        return None
    return {"node_adjustments": adjustments}


@register("init_adjust")
def optimize_init_adjust(store: MetricsStore, req: OptimizeRequest):
    """Early-phase right-sizing, before steady-state stats exist.

    Reference optimize_job_ps_init_adjust_resource.go: while the step
    count is under a threshold, extrapolate the observed per-node usage
    to the target worker count plus a margin — catch under-provisioning
    in the first minutes instead of after an OOM."""
    records = store.job_records(req.job_uuid, limit=50)
    if not records:
        return None
    samples = _runtime_samples(records)
    if samples:
        from dlrover_tpu_torch.brain.runtime_opt import (
            optimize_ps_init_adjust_windowed,
        )

        plan = optimize_ps_init_adjust_windowed(
            samples, req.config,
            model_feature=req.config.get("model_feature"),
        )
        if plan is not None:
            return plan
    step_threshold = int(req.config.get("step_count_threshold", 100))
    latest_step = next(
        (int(r["global_step"]) for r in records
         if r.get("global_step") is not None),
        0,
    )
    if latest_step >= step_threshold:
        return None  # past the init window; worker_resource takes over
    mems = [
        float(r["used_memory_mb"]) for r in records
        if r.get("used_memory_mb")
    ]
    if not mems:
        return None
    target_workers = int(req.config.get("target_worker_count", 0))
    current_workers = int(
        req.config.get("worker_count")
        or next(
            (r["worker_count"] for r in records
             if r.get("worker_count")), 1,
        )
    )
    headroom = float(req.config.get("init_headroom", 1.6))
    scale = (
        max(target_workers / max(current_workers, 1), 1.0)
        if target_workers else 1.0
    )
    return {"memory_mb": int(max(mems) * scale * headroom)}


@register("job_completion")
def optimize_job_completion(store: MetricsStore, req: OptimizeRequest):
    """Estimate time-to-completion from recent throughput.

    The scheduler-facing half of the reference brain's job-runtime
    estimation: fit steps/second over the newest records and project
    the remaining steps; jobs without a known max_steps report their
    throughput only."""
    records = store.job_records(req.job_uuid, limit=100)
    stepped = [
        (float(r["timestamp"]), int(r["global_step"]))
        for r in records if r.get("global_step") is not None
    ]
    if len(stepped) < 2:
        return None
    stepped.sort()
    (t0, s0), (t1, s1) = stepped[0], stepped[-1]
    if t1 <= t0 or s1 <= s0:
        return None
    speed = (s1 - s0) / (t1 - t0)
    plan = {"steps_per_second": round(speed, 4)}
    max_steps = int(req.config.get("max_steps", 0))
    if max_steps > s1:
        remaining = (max_steps - s1) / speed
        plan["estimated_remaining_s"] = int(remaining)
        plan["estimated_completion_ts"] = int(t1 + remaining)
    return plan

"""Windowed runtime-resource optimization (the deep brain algorithms).

Equivalent capability: the reference Go brain's historical-utilization
algorithms —
``optimize_job_worker_resource.go`` (speed-state detection over the
last replica change, singularity filtering, idle/exhausted-PS worker
scaling, windowed max/avg usage sizing),
``optimize_job_hot_ps_resource.go`` (hot-CPU/-memory node detection
over a sample window, proportional PS-CPU scale-up capped at 32 cores),
``optimize_job_ps_init_adjust_resource.go`` (first-minutes PS sizing
from model features + observed usage), and their shared helpers in
``pkg/optimizer/implementation/utils/`` (CalculateJobNodeAvgResources /
MaxResource, GetMaxUtil, CheckHotCPUNodes).

A runtime sample mirrors the reference's JobRuntimeInfo
(pkg/common/optimize.go): a dict with

    {"speed": float,                       # global samples/sec
     "worker_cpu": {id: used_cores},
     "worker_memory": {id: used_bytes_or_mb},
     "ps_cpu": {id: used_cores},
     "ps_memory": {id: used}}

Samples are ordered OLDEST-FIRST (the reference's JobRuntime array).
All functions are pure over (samples, capacities, config) so the test
fixtures reproduce the reference *_test.go scenarios table-driven.

The PyTorch port's copy of dlrover_tpu/brain/runtime_opt.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

import math

# window length the reference averages over (optimplcomm
# NRecordToAvgResource) and its speed states
N_RECORD_TO_AVG = 3
SPEED_STABLE = "stable"
SPEED_INCREASED = "increased"
SPEED_DECELERATED = "decelerated"

_ENOUGH_RECORDS = 3               # defaultEnoughRecordNum
_INIT_RECORD_THRESHOLD = 6        # initTrainingRecordNumThres
# memory units follow the samples: the master's collector reports MiB
_MAX_WORKER_ADD_MEMORY = 8 * 1024  # MiB (reference caps at 8 GiB)
_MAX_PS_CPU = 32                  # maxCPUThreshold (hot-PS cap)
_DEFAULT_MAX_PS_COUNT = 15        # optimplcomm.DefaultMaxPSCount
_INIT_STEP_TIME = 1800.0          # initStepTime (s): short jobs stay small
_DEFAULT_INIT_WORKER = 10         # defaultInitWorker


def _res(sample: dict, key: str) -> dict:
    return {int(k): float(v) for k, v in (sample.get(key) or {}).items()}


def node_avg_resources(samples, key: str, window: int = N_RECORD_TO_AVG):
    """Per-node mean of the newest ``window`` samples
    (CalculateJobNodeAvgResources, runtime.go:23)."""
    window = min(window, len(samples))
    sums: dict[int, float] = {}
    counts: dict[int, float] = {}
    for sample in samples[len(samples) - window:]:
        for n, v in _res(sample, key).items():
            sums[n] = sums.get(n, 0.0) + v
            counts[n] = counts.get(n, 0.0) + 1
    return {
        n: (s / counts[n] if s > 0 else 0.0) for n, s in sums.items()
    }


def node_max_resources(samples, key: str, window: int = N_RECORD_TO_AVG):
    """Per-node max over the newest ``window`` samples
    (CalculateJobNodeMaxResource, runtime.go:57)."""
    window = min(window, len(samples))
    out: dict[int, float] = {}
    for sample in samples[len(samples) - window:]:
        for n, v in _res(sample, key).items():
            if v > out.get(n, 0.0):
                out[n] = v
    return out


def max_util(useds: dict, capacities: dict) -> float:
    """Max used/capacity over nodes present in both maps
    (GetMaxUtil, math.go:68)."""
    best = 0.0
    for n, used in useds.items():
        cap = capacities.get(n)
        if not cap:
            continue
        best = max(best, used / cap)
    return best


def hot_cpu_nodes(samples, node_cpus: dict, threshold: float,
                  window: int = N_RECORD_TO_AVG) -> list[int]:
    """Nodes whose window-avg CPU util exceeds ``threshold``
    (CheckHotCPUNodes, optimize_algorithm.go:231)."""
    if len(samples) < window:
        return []
    avg = node_avg_resources(samples, "ps_cpu", window)
    return sorted(
        n for n, cpu in avg.items()
        if node_cpus.get(n) and cpu / node_cpus[n] > threshold
    )


def hot_memory_nodes(samples, node_memory: dict, threshold: float,
                     window: int = N_RECORD_TO_AVG) -> list[int]:
    """Nodes over the memory threshold in EVERY one of the newest
    ``window`` samples (checkHotMemoryNodes — stricter than the CPU
    variant: one calm sample clears the node)."""
    if len(samples) < window:
        return []
    counts: dict[int, int] = {
        n: 0 for n in _res(samples[-1], "ps_memory")
    }
    for sample in samples[len(samples) - window:]:
        for n, mem in _res(sample, "ps_memory").items():
            cap = node_memory.get(n)
            if cap and mem / cap > threshold:
                counts[n] = counts.get(n, 0) + 1
    return sorted(n for n, c in counts.items() if c >= window)


def filter_singularities(samples, ps_cpus: dict, overload_util: float,
                         comp_count: int, less_percent: float):
    """Drop samples whose PS set differs from the latest, and transient
    per-sample util spikes no neighbour within ``comp_count`` records
    corroborates (preProcessRuntimeInfos,
    optimize_job_worker_resource.go:345)."""
    if not samples:
        return []
    last_ids = set(_res(samples[-1], "ps_cpu"))
    out = []
    n = len(samples)
    valid = 0
    for i, sample in enumerate(samples):
        if set(_res(sample, "ps_cpu")) != last_ids:
            continue
        if valid == 0 or i == n - 1:
            out.append(sample)
            valid += 1
            continue
        util = max_util(_res(sample, "ps_cpu"), ps_cpus)
        if util <= overload_util:
            out.append(sample)
            valid += 1
            continue
        singular = True
        for j in range(i - comp_count, i + comp_count + 1):
            if j < 0 or j == i or j >= n:
                continue
            comp = max_util(_res(samples[j], "ps_cpu"), ps_cpus)
            if util <= comp or (util - comp) / util < less_percent:
                singular = False
                break
        if not singular:
            out.append(sample)
            valid += 1
    return out


def training_speed_state(samples, count: int,
                         less_percent: float) -> str:
    """Compare avg speed across the most recent worker-replica change
    (getTrainingSpeedState, optimize_job_worker_resource.go:243).

    Returns ``stable`` when there is not enough history after the
    change, ``increased``/``decelerated`` from the before/after means.
    """
    n = len(samples)
    cur_replica = 0
    boundary = -1
    for i in range(n - 1, -1, -1):
        replica = len(_res(samples[i], "worker_cpu"))
        if cur_replica == 0:
            cur_replica = replica
        elif replica != cur_replica:
            boundary = i
            break
    if boundary > n - count - 1:
        return SPEED_STABLE
    if boundary < count - 1:
        return SPEED_INCREASED
    pre = sum(
        float(samples[i].get("speed", 0.0))
        for i in range(boundary, boundary - count, -1)
    ) / count
    post = sum(
        float(samples[i].get("speed", 0.0))
        for i in range(boundary + 1, boundary + count + 1)
    ) / count
    if pre > post and (pre - post) / pre >= less_percent:
        return SPEED_DECELERATED
    if pre < post:
        return SPEED_INCREASED
    return SPEED_STABLE


def optimize_worker_resource_windowed(samples, ps_cpus: dict,
                                      config: dict) -> dict | None:
    """Runtime worker count + size from utilization windows
    (OptimizeJobWorkerResource, optimize_job_worker_resource.go:45).

    Decision order: exhausted PS nodes shrink the fleet; idle PS CPU
    grows it toward the overload target (bounded per step and by the
    phase rules); memory = all-history peak * (1 + margin) with an 8 GB
    cap on the increase; CPU = window max (startup) or window avg
    (stable) of per-worker usage + margin cores.
    """
    if not ps_cpus or not any(
        v > 0 for s in samples for v in _res(s, "ps_cpu").values()
    ):
        # no PS load signal: the idle-PS growth rule would fire
        # unconditionally for worker-only SPMD jobs — defer to the
        # legacy usage-based sizing instead
        return None
    comp_count = int(config.get("cpu_util_comp_count", 2))
    samples = filter_singularities(
        samples, ps_cpus,
        float(config.get("ps_cpu_overload", 0.8)), comp_count,
        float(config.get("cpu_util_less_percent", 0.15)),
    )
    if len(samples) < comp_count:
        return None
    latest = samples[-1]
    replica = cur_replica = len(_res(latest, "worker_cpu"))
    if replica == 0:
        return None

    overload = float(config.get("ps_cpu_overload", 0.8))
    exhausted_thr = float(config.get("ps_cpu_exhausted", 0.95))
    step_count = int(config.get("step_count_threshold", 5))
    less_percent = float(config.get("speed_less_percent", 0.1))
    max_replica = int(config.get("max_replica", 64))
    decrease = int(config.get("replica_decrease_count", 1))
    max_per_step = int(config.get("max_count_per_step", 4))
    phase = config.get("phase", "stable")

    ps_max_cpu = node_max_resources(samples, "ps_cpu")
    util = max_util(ps_max_cpu, ps_cpus)
    state = training_speed_state(samples, step_count, less_percent)
    exhausted = hot_cpu_nodes(
        samples, ps_cpus, exhausted_thr, window=_ENOUGH_RECORDS)

    if exhausted:
        if replica > decrease:
            replica -= decrease
    elif util < overload and state != SPEED_DECELERATED:
        if util <= 0.0:
            replica += max_per_step
        else:
            replica = math.ceil((overload / util) * cur_replica)
        if phase in ("initial", "sample"):
            replica = min(
                int(config.get("max_init_count_per_step", 32)), replica)
        elif phase == "stable" and state == SPEED_INCREASED:
            replica = cur_replica + min(
                max_per_step, replica - cur_replica)
        # stable + stable speed keeps the computed replica (capped below)

    if len(samples) < _INIT_RECORD_THRESHOLD:
        # startup: worker CPU is unstable — size from the window max
        worker_cpu = node_max_resources(samples, "worker_cpu")
    else:
        worker_cpu = node_avg_resources(samples, "worker_cpu")
    cpu = max(worker_cpu.values(), default=0.0)
    memory = max(
        (
            mem
            for sample in samples
            for mem in _res(sample, "worker_memory").values()
        ),
        default=0.0,
    )
    add = min(
        memory * float(config.get("memory_margin_percent", 0.2)),
        _MAX_WORKER_ADD_MEMORY,
    )
    memory += add
    if cpu > 0.0:
        cpu = math.ceil(cpu + float(config.get("cpu_margin_cores", 1.0)))
    return {
        "worker_count": min(replica, max_replica),
        "cpu_cores": cpu,
        "memory_mb": memory,
        "source": "windowed",
    }


def optimize_hot_ps_windowed(samples, ps_cpus: dict, ps_memory: dict,
                             config: dict) -> dict | None:
    """Per-node PS scale-up for hot nodes
    (OptimizeJobHotPSResource, optimize_job_hot_ps_resource.go:42).

    Hot-CPU nodes: every PS's window-avg CPU is scaled by
    target_workers / current_workers, capped at 32 cores (the cap
    re-derives the common ratio so the fleet stays proportional); only
    nodes whose new CPU exceeds their capacity get a plan entry.
    Hot-memory nodes get a fixed memory adjustment.
    """
    cpu_thr = float(config.get("hot_cpu_threshold", 0.8))
    mem_thr = float(config.get("hot_memory_threshold", 0.9))
    target_workers = int(config.get("target_worker_count", 20))
    mem_adjust = float(config.get("memory_adjust", 4096))

    hot_cpu = hot_cpu_nodes(samples, ps_cpus, cpu_thr)
    hot_mem = hot_memory_nodes(samples, ps_memory, mem_thr)
    plans: dict[int, dict] = {}

    if hot_cpu:
        cur_workers = len(_res(samples[-1], "worker_cpu"))
        avg_cpu = node_avg_resources(samples, "ps_cpu")
        coeff = (
            target_workers / cur_workers if cur_workers > 0
            else float("inf")
        )
        for n in hot_cpu:
            raw = avg_cpu[n] * coeff
            if not math.isfinite(raw) or math.ceil(raw) > _MAX_PS_CPU:
                coeff = _MAX_PS_CPU / avg_cpu[n]
        for n, cpu in avg_cpu.items():
            # fleet-wide ceiling: the coeff re-derivation above only
            # saw hot nodes; a colder node with a larger absolute avg
            # must not be planned past the cap either
            opt = min(math.ceil(cpu * coeff), _MAX_PS_CPU)
            if opt > ps_cpus.get(n, float("inf")):
                plans[str(n)] = {"cpu_cores": opt}
    for n in hot_mem:
        total = ps_memory.get(n)
        if total is None:
            continue
        plans.setdefault(str(n), {})["memory_mb"] = total + mem_adjust
    if not plans:
        return None
    # str node keys + *_mb field names keep the schema compatible with
    # the legacy hot_ps plan consumers; "source" lets callers detect
    # the windowed decision
    return {"node_adjustments": plans, "source": "windowed"}


def optimize_ps_init_adjust_windowed(samples, config: dict,
                                     model_feature: dict | None = None,
                                     ) -> dict | None:
    """Early-run PS sizing from model features + first observed usage
    (OptimizeJobPSInitAdjustResource,
    optimize_job_ps_init_adjust_resource.go:40).

    PS CPU from the recv-op density (0.08 cores/op + margin, 16-core
    default past 150 ops/PS), floored at observed max + margin; PS
    count from the target total CPU a scaled-up worker fleet would
    drive; memory = latest per-node max * (1 + margin).
    """
    if not samples:
        return None
    latest = samples[-1]
    ps_cpu_latest = _res(latest, "ps_cpu")
    cur_ps = len(ps_cpu_latest)
    if cur_ps == 0:
        return None
    margin_cpu = float(config.get("ps_margin_cpu", 4))
    mem_margin = float(config.get("ps_memory_margin_percent", 0.2))
    target_workers = float(config.get("target_worker_count", 32))
    step_count = int(config.get("step_count_threshold", 5))

    avg_cpu = node_avg_resources(samples, "ps_cpu")

    # avg per-sample speed over the newest window (ComputeAvgSpeed)
    window = samples[len(samples) - min(step_count, len(samples)):]
    speeds = [float(s.get("speed", 0.0)) for s in window]
    avg_speed = sum(speeds) / len(speeds) if speeds else 0.0
    if avg_speed <= 0:
        # speed 0.0 is indistinguishable from "monitor not configured"
        # (client.py) — scaling the PS fleet to zero on a missing
        # signal would kill every parameter server
        return None
    total_steps = float(config.get("total_steps", 0))
    if total_steps and total_steps / avg_speed <= _INIT_STEP_TIME:
        worker_target = float(_DEFAULT_INIT_WORKER)
    else:
        worker_target = target_workers

    recv_per_ps = (
        float((model_feature or {}).get("recv_op_count", 0)) / cur_ps
    )
    ps_cpu = 16.0
    if recv_per_ps <= 150:
        ps_cpu = math.ceil(0.08 * recv_per_ps) + margin_cpu
    max_ps_cpu = math.ceil(max(avg_cpu.values(), default=0.0))
    ps_cpu = max(ps_cpu, max_ps_cpu + margin_cpu)

    max_sum_used = max(
        (sum(_res(s, "ps_cpu").values()) for s in samples), default=0.0
    )
    max_used_memory = max(_res(latest, "ps_memory").values(), default=0.0)
    workers = len(_res(latest, "worker_cpu"))
    if workers == 0 or max_sum_used <= 0:
        return None

    # scaling the PS fleet spreads the load: estimate the per-PS peak
    # after growth, and the skew-limited free rate when variables are
    # unevenly partitioned (computePSCPUDiff)
    est_max = max_ps_cpu / (_DEFAULT_MAX_PS_COUNT / cur_ps)
    free_rate = ps_cpu / est_max if est_max > 0 else 1.0
    if len(avg_cpu) > 1:
        hottest = max(avg_cpu, key=avg_cpu.get)
        rest = [v for n, v in avg_cpu.items() if n != hottest]
        if rest and sum(rest) > 0:
            diff = avg_cpu[hottest] - sum(rest) / len(rest)
            if diff > 0 and free_rate > ps_cpu / diff:
                free_rate = ps_cpu / diff
    est_workers = math.ceil(free_rate * workers)
    worker_target = min(worker_target, est_workers)
    target_total_cpu = (worker_target / workers) * max_sum_used
    ps_replica = math.ceil(target_total_cpu / ps_cpu)

    return {
        "ps_count": int(ps_replica),
        "ps_cpu_cores": float(ps_cpu),
        "ps_memory_mb": max_used_memory * (1 + mem_margin),
        "source": "windowed",
    }

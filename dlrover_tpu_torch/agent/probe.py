"""Join-time hardware health probe: per-leg timings shipped with the join.

Equivalent capability: the reference admits a node only after a
``NetworkCheckElasticAgent`` runs a matmul + repeated-allgather payload
and kills hosts that fail it (node_check/nvidia_gpu.py); our
node_check.py reproduces the pass/fail half for dedicated probe rounds.
This module is the *graded* half: three timed legs run by the agent
BEFORE ``rdzv.join``, with per-leg milliseconds shipped in
``JoinRendezvousRequest.probe_report`` so the master's health gate
(master/health.py) can judge the host against the fleet median AND its
own persisted fingerprint — pass / quarantine / refuse instead of the
binary normal flag.

Legs (GPU; CPU smoke-arm stand-ins in parentheses):

- ``hbm``        — HBM-bandwidth microbench: on-device tensor copy
                   rounds (host memcpy over a scaled buffer).
- ``matmul``     — a bf16 tensor-core matmul round per local card
                   (numpy matmul).
- ``collective`` — N NCCL all_reduce rounds; one rank on card 0, so on
                   one card it is a one-rank all_reduce (loopback-socket
                   round trips: the only in-process stand-in that still
                   exercises a real network stack).

The PyTorch port's copy of dlrover_tpu/agent/probe.py. The agent must
never create a CUDA context (it would hold device memory for the whole
job and tie the agent's life to the device's), so on a GPU host the
legs run in a short-lived child, ``python -m dlrover_tpu_torch.agent.probe
--child``, that prints its legs as JSON; ``elapsed_s`` is the whole
probe's cost as the agent pays it, the child's start included.

Every leg opens its timed window with ``chaos_point("probe.degrade",
leg=..., rank=...)`` — the ``degrade`` action (common/chaos.py) injects
a seeded, scaled sleep *inside* the measurement, so a chaos rule with a
MOCK_ERR-style rank anchor makes exactly that host's legs look slow and
the master's 2x-median rule (the straggler blamer's constant) does the
rest. ``MOCK_ERR_RANK`` itself is honored too: the anchored host's
probe reports an error and the gate refuses it, mirroring node_check.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

PROBE_LEGS = ("hbm", "matmul", "collective")

# leg sizing (env-overridable: chaos arms shrink them, soak arms grow
# them). Defaults keep the whole CPU smoke-arm probe well under the 5 s
# join-overhead budget the bad-host schedule asserts.
HBM_BYTES = int(os.environ.get("DLROVER_PROBE_HBM_BYTES", str(1 << 24)))
HBM_ROUNDS = int(os.environ.get("DLROVER_PROBE_HBM_ROUNDS", "4"))
MATMUL_SIZE = int(os.environ.get("DLROVER_PROBE_MATMUL_SIZE", "256"))
MATMUL_ROUNDS = int(os.environ.get("DLROVER_PROBE_MATMUL_ROUNDS", "4"))
COLLECTIVE_BYTES = int(
    os.environ.get("DLROVER_PROBE_COLLECTIVE_BYTES", str(1 << 20))
)
COLLECTIVE_ROUNDS = int(
    os.environ.get("DLROVER_PROBE_COLLECTIVE_ROUNDS", "8")
)

# re-probe cadence: a quarantined host re-probes on the master's
# backoff schedule; an ADMITTED host re-probes in band at this floor
# cadence (stretched by the cost governor below, never tightened)
REPROBE_INTERVAL_S = float(
    os.environ.get("DLROVER_PROBE_REPROBE_INTERVAL", "600")
)
# the in-band re-probe's steady-state overhead budget, as a percent of
# the interval it rides — same contract (and default) as the device-
# time sampler's window governor (common/profiling.py)
REPROBE_OVERHEAD_PCT = float(
    os.environ.get("DLROVER_PROBE_OVERHEAD_PCT", "2.0")
)


def _node_rank() -> int:
    try:
        return int(os.environ.get(NodeEnv.NODE_RANK, "0"))
    except ValueError:
        return 0


def _mock_error() -> bool:
    """MOCK_ERR_RANK=<node_rank> makes that node's probe error out —
    the same injection contract node_check honors."""
    mock_rank = os.environ.get(NodeEnv.MOCK_ERR_RANK, "")
    return mock_rank != "" and mock_rank == os.environ.get(
        NodeEnv.NODE_RANK, "0"
    )


def _device_backend() -> str:
    """``"cuda"`` when the host has a card, or '' for the host stand-in
    path. ``device_count`` creates no CUDA context; import failures gate
    to the stand-ins instead of erroring."""
    try:
        import torch

        if torch.cuda.device_count() > 0:
            return "cuda"
    except Exception:  # noqa: BLE001 - no torch / no driver -> host arm
        pass
    return ""


# ---------------------------------------------------------------- legs


def hbm_probe(rank: int, device: bool) -> float:
    """HBM-bandwidth leg: on-device copy rounds (host memcpy on the
    smoke arm). Returns elapsed milliseconds.

    The warmup pass runs OUTSIDE the timed window: allocation and
    page-fault noise on a first touch is 2x-scale — big enough to trip
    the gate's 2x-median rule on a perfectly healthy host."""
    if device:
        import torch

        x = torch.ones(HBM_BYTES // 4, dtype=torch.float32, device="cuda")
        x + 0.0  # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chaos_point("probe.degrade", leg="hbm", rank=rank)
        for _ in range(HBM_ROUNDS):
            x = x + 0.0
        torch.cuda.synchronize()
    else:
        src = bytearray(HBM_BYTES)
        dst = bytearray(HBM_BYTES)  # preallocated: copies, no allocs
        dst[:] = src  # warmup (faults both buffers in)
        t0 = time.perf_counter()
        chaos_point("probe.degrade", leg="hbm", rank=rank)
        for _ in range(HBM_ROUNDS):
            dst[:] = src
    return (time.perf_counter() - t0) * 1000.0


def matmul_probe(rank: int, device: bool) -> float:
    """Tensor-core leg: a bf16 matmul round per local card (numpy on the
    smoke arm). Returns elapsed milliseconds. Warmup outside the window
    (lazy cuBLAS/BLAS init must not read as slow hardware)."""
    if device:
        import torch

        xs = [
            torch.ones(MATMUL_SIZE, MATMUL_SIZE, dtype=torch.bfloat16,
                       device=f"cuda:{i}")
            for i in range(torch.cuda.device_count())
        ]
        for x in xs:
            torch.matmul(x, x) / MATMUL_SIZE  # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chaos_point("probe.degrade", leg="matmul", rank=rank)
        for x in xs:
            for _ in range(MATMUL_ROUNDS):
                x = torch.matmul(x, x) / MATMUL_SIZE
        torch.cuda.synchronize()
    else:
        import numpy as np

        x = np.ones((MATMUL_SIZE, MATMUL_SIZE), dtype=np.float32)
        (x @ x) / MATMUL_SIZE  # warmup
        t0 = time.perf_counter()
        chaos_point("probe.degrade", leg="matmul", rank=rank)
        for _ in range(MATMUL_ROUNDS):
            x = (x @ x) / MATMUL_SIZE
    return (time.perf_counter() - t0) * 1000.0


def collective_probe(rank: int, device: bool) -> float:
    """Collective leg: NCCL all_reduce rounds of one rank on card 0
    (loopback-socket round trips on the smoke arm — the one stand-in
    that still pushes bytes through a real network stack). Returns
    elapsed milliseconds. Setup and a warmup round run outside the
    timed window (communicator setup / socket handshake are not the
    hardware under test)."""
    if device:
        import torch
        import torch.distributed as dist

        from dlrover_tpu_torch.common.rpc import find_free_port

        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{find_free_port()}",
            world_size=1, rank=0,
        )
        try:
            x = torch.ones(max(COLLECTIVE_BYTES // 4, 1),
                           dtype=torch.float32, device="cuda")
            dist.all_reduce(x)  # warmup (communicator setup)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chaos_point("probe.degrade", leg="collective", rank=rank)
            for _ in range(COLLECTIVE_ROUNDS):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1000.0
        finally:
            dist.destroy_process_group()
    server, sender, conn = _loopback_pair()
    try:
        _loopback_rounds(sender, conn, 1)  # warmup
        t0 = time.perf_counter()
        chaos_point("probe.degrade", leg="collective", rank=rank)
        _loopback_rounds(sender, conn, COLLECTIVE_ROUNDS)
        return (time.perf_counter() - t0) * 1000.0
    finally:
        sender.close()
        conn.close()
        server.close()


def _loopback_pair():
    """A connected 127.0.0.1 socket pair (server, sender, receiver)."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        server.bind(("127.0.0.1", 0))
        server.listen(1)
        sender = socket.create_connection(
            server.getsockname(), timeout=10
        )
        conn, _ = server.accept()
    except Exception:
        server.close()
        raise
    return server, sender, conn


def _loopback_rounds(sender, conn, rounds: int):
    """Push COLLECTIVE_BYTES through the pair per round — send and
    drain on the same thread in chunks small enough to never deadlock
    against the kernel buffers."""
    chunk = b"\x00" * 65536
    for _ in range(rounds):
        remaining = COLLECTIVE_BYTES
        while remaining > 0:
            part = chunk[: min(len(chunk), remaining)]
            sender.sendall(part)
            got = 0
            while got < len(part):
                got += len(conn.recv(len(part) - got))
            remaining -= len(part)


# --------------------------------------------------------------- probe


def _run_legs(rank: int, device: bool) -> dict:
    return {
        "hbm": round(hbm_probe(rank, device), 3),
        "matmul": round(matmul_probe(rank, device), 3),
        "collective": round(collective_probe(rank, device), 3),
    }


# the child's stdout line that carries its legs
_CHILD_TAG = "PROBE_LEGS="
CHILD_TIMEOUT_S = 120.0


def _device_legs_in_child(rank: int) -> dict:
    """Run the device legs in a child process, so the CUDA context lives
    and dies with it; raises with the child's output when it fails."""
    proc = subprocess.run(  # noqa: S603
        [sys.executable, "-m", "dlrover_tpu_torch.agent.probe", "--child",
         str(rank)],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    for line in proc.stdout.splitlines():
        if line.startswith(_CHILD_TAG):
            return json.loads(line[len(_CHILD_TAG):])
    raise RuntimeError(
        f"probe child exited {proc.returncode}: "
        f"{(proc.stdout + proc.stderr)[-2000:]}"
    )


def run_probe(node_rank: int | None = None) -> dict:
    """Run all three legs; returns the join-payload report::

        {"legs": {"hbm": ms, "matmul": ms, "collective": ms},
         "elapsed_s": s, "host": rank, "backend": "cuda"|"host",
         "error": "", "t": wall}

    A leg failure (or MOCK_ERR_RANK) lands in ``error`` — the master's
    gate refuses hosts whose probe errored, exactly like node_check's
    binary fail. Never raises."""
    rank = _node_rank() if node_rank is None else int(node_rank)
    t0 = time.perf_counter()
    backend = _device_backend()
    legs: dict[str, float] = {}
    error = ""
    try:
        if _mock_error():
            raise RuntimeError(
                "mock probe failure injected via MOCK_ERR_RANK"
            )
        if backend:
            legs = _device_legs_in_child(rank)
        else:
            legs = _run_legs(rank, device=False)
    except Exception as e:  # noqa: BLE001 - a probe failure is a
        # verdict (refuse), not an agent crash
        logger.error("hardware probe failed: %s", e)
        error = str(e)
    elapsed = time.perf_counter() - t0
    report = {
        "legs": legs,
        "elapsed_s": round(elapsed, 4),
        "host": rank,
        "backend": backend or "host",
        "error": error,
        "t": time.time(),
    }
    logger.info(
        "hardware probe: %s (%.0f ms total)%s",
        {k: f"{v:.1f}ms" for k, v in legs.items()},
        elapsed * 1000,
        f" ERROR={error}" if error else "",
    )
    return report


class ProbeScheduler:
    """Cadence governor for the agent's in-band re-probe, mirroring the
    device-time sampler's window governor: ``interval`` is the FLOOR,
    and each probe's measured cost stretches the next gap until the
    steady-state overhead stays under ``overhead_pct`` of the wait — an
    always-on health signal that self-limits instead of taxing the
    monitor loop. The join-time report seeds the cache so a fresh join
    never immediately re-pays the probe."""

    def __init__(
        self,
        interval_s: float | None = None,
        overhead_pct: float | None = None,
    ):
        self.interval = float(
            REPROBE_INTERVAL_S if interval_s is None else interval_s
        )
        frac = (
            REPROBE_OVERHEAD_PCT if overhead_pct is None else overhead_pct
        )
        self._overhead_frac = max(float(frac), 0.0) / 100.0
        self._next_t = 0.0
        self.last_report: dict | None = None
        self.last_gap = self.interval

    def seed(self, report: dict, now: float | None = None):
        """Adopt a join-time report as the freshest sample."""
        now = time.time() if now is None else now
        self.last_report = report
        self._arm(float(report.get("elapsed_s", 0.0)), now)

    def _arm(self, cost_s: float, now: float):
        gap = self.interval
        if self._overhead_frac > 0 and cost_s > 0:
            gap = max(gap, cost_s / self._overhead_frac)
        self.last_gap = gap
        self._next_t = now + gap

    def due(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        return now >= self._next_t

    def run(self, node_rank: int | None = None) -> dict:
        """Run the re-probe now and re-arm from its measured cost."""
        report = run_probe(node_rank)
        self.seed(report)
        return report


def probe_disabled() -> bool:
    """DLROVER_PROBE_DISABLE=1 skips the probe entirely: joins carry an
    empty report, which the master's gate admits (pre-health-plane
    behavior) — the opt-out for arms where even milliseconds matter."""
    return os.environ.get("DLROVER_PROBE_DISABLE", "") == "1"


_SCHEDULER: ProbeScheduler | None = None


def default_scheduler() -> ProbeScheduler:
    """The process-wide scheduler: the rendezvous handlers (elastic
    training AND network check) and the monitor loop share one cache,
    so back-to-back joins don't each re-pay the probe."""
    global _SCHEDULER
    if _SCHEDULER is None:
        _SCHEDULER = ProbeScheduler()
    return _SCHEDULER


def main(argv=None):
    """``--child RANK``: run the device legs here and print them (the
    agent's child); without it, the whole probe (per-leg ms, exit 1 on
    error)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        legs = _run_legs(int(argv[1]), device=True)
        print(_CHILD_TAG + json.dumps(legs), flush=True)
        raise SystemExit(0)
    report = run_probe()
    raise SystemExit(0 if not report["error"] else 1)


if __name__ == "__main__":
    main()

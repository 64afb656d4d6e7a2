"""Node health-check payload: device matmul + collective probe.

Equivalent capability: reference dlrover/trainer/torch/node_check/
nvidia_gpu.py:26 (matmul rounds + 10x allgather of 2^24 floats, elapsed
time written to a per-rank file; MOCK_ERR_RANK fault injection
utils.py:50). The agent times the run and reports (normal, elapsed) to
the master, whose pairing logic (master/rendezvous.py
NetworkCheckRendezvousManager) isolates the faulty node.

The PyTorch port's rewrite of dlrover_tpu/agent/node_check.py. The probe
runs in child processes, one per local rank (one per card), so the
agent never creates a CUDA context: each child runs a bf16
``torch.matmul`` loop on its card (tensor-core exercise), then
``all_reduce`` and ``all_gather`` rounds over an NCCL group of the
node's local ranks (NVLink exercise; a world of 1 on a one-card host),
destroys the group and exits before any worker starts. The caller may
ask for the CPU (``device="cpu"``: a gloo group, as the tests run it);
the probe never falls back to the CPU on its own, and a host without a
card fails the check.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# the port's own directory under the temp dir: a JAX-package agent on
# the same host never reads or writes these files
CHECK_TIME_DIR = os.path.join(
    tempfile.gettempdir(), "dlrover_tpu_torch", "node_check"
)

MATMUL_SIZE = 1024
MATMUL_ROUNDS = 10
COLLECTIVE_ELEMS = 1 << 22  # 4M floats ~= 16MB, split over the ranks
COLLECTIVE_ROUNDS = 10

# the rank-0 child's stdout line that carries the legs
_CHILD_TAG = "NODE_CHECK_LEGS="
CHILD_TIMEOUT_S = 120.0


def _mock_error() -> bool:
    """Fault injection: MOCK_ERR_RANK=<node_rank> makes that node fail."""
    mock_rank = os.environ.get(NodeEnv.MOCK_ERR_RANK, "")
    node_rank = os.environ.get(NodeEnv.NODE_RANK, "0")
    return mock_rank != "" and mock_rank == node_rank


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def matmul_probe(device) -> float:
    """Time a bf16 matmul loop on ``device`` (tensor-core health), after
    one warm-up round outside the window. Returns seconds."""
    import torch

    x = torch.ones((MATMUL_SIZE, MATMUL_SIZE), dtype=torch.bfloat16,
                   device=device)
    # warm-up: the BLAS handle and the first launch of each kernel
    # (loaded lazily) are not the hardware
    torch.matmul(x, x) / MATMUL_SIZE
    _sync(device)
    start = time.perf_counter()
    for _ in range(MATMUL_ROUNDS):
        x = torch.matmul(x, x) / MATMUL_SIZE
    _sync(device)
    return time.perf_counter() - start


def collective_probe(device) -> tuple[float, float]:
    """Time ``all_reduce`` and ``all_gather`` rounds over the current
    process group, after one warm-up round of each outside the windows
    (communicator setup is not the link under test). Returns
    ``(all_reduce_s, all_gather_s)``."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.ones(COLLECTIVE_ELEMS // world, dtype=torch.float32,
                   device=device)
    out = torch.empty(x.numel() * world, dtype=x.dtype, device=device)
    dist.all_reduce(x)
    dist.all_gather_into_tensor(out, x)
    _sync(device)
    start = time.perf_counter()
    for _ in range(COLLECTIVE_ROUNDS):
        dist.all_reduce(x)
    _sync(device)
    reduce_s = time.perf_counter() - start
    start = time.perf_counter()
    for _ in range(COLLECTIVE_ROUNDS):
        dist.all_gather_into_tensor(out, x)
    _sync(device)
    return reduce_s, time.perf_counter() - start


def _child(rank: int, world: int, init_method: str, device: str) -> dict:
    """One local rank of the probe: its legs on its card (or the CPU),
    inside a group of the node's local ranks that is destroyed before
    the process exits."""
    import torch
    import torch.distributed as dist

    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend, kind = "nccl", torch.cuda.get_device_name(dev)
    else:
        dev, backend, kind = torch.device("cpu"), "gloo", "cpu"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        matmul_s = matmul_probe(dev)
        reduce_s, gather_s = collective_probe(dev)
    finally:
        dist.destroy_process_group()
    return {"device": device, "kind": kind, "backend": backend,
            "world": world, "pid": os.getpid(),
            "matmul_ms": matmul_s * 1e3, "all_reduce_ms": reduce_s * 1e3,
            "all_gather_ms": gather_s * 1e3}


def _legs_in_children(device: str, nprocs: int) -> dict:
    """Start one child per local rank and wait for all of them; returns
    rank 0's legs, or raises with the output of a child that failed."""
    from dlrover_tpu_torch.common.rpc import find_free_port

    if device == "cuda":
        import torch

        # device_count creates no CUDA context in this process
        cards = torch.cuda.device_count()
        if cards < nprocs:
            raise RuntimeError(
                f"the node check needs {nprocs} CUDA device(s), this "
                f"host has {cards}")
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    init = f"tcp://127.0.0.1:{find_free_port()}"
    procs = [
        subprocess.Popen(  # noqa: S603
            [sys.executable, "-m", "dlrover_tpu_torch.agent.node_check",
             "--child", str(rank), str(nprocs), init, device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(nprocs)
    ]
    outputs, failed = [], []
    deadline = time.time() + CHILD_TIMEOUT_S
    for proc in procs:
        try:
            out, _ = proc.communicate(
                timeout=max(deadline - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failed.append((proc.returncode, out[-2000:]))
    if failed:
        raise RuntimeError(f"node check child(ren) failed: {failed}")
    for line in outputs[0].splitlines():
        if line.startswith(_CHILD_TAG):
            return json.loads(line[len(_CHILD_TAG):])
    raise RuntimeError(f"node check child printed no legs: "
                       f"{outputs[0][-2000:]}")


def write_time_to_file(elapsed: float, normal: bool, local_rank: int = 0,
                       legs: dict | None = None):
    os.makedirs(CHECK_TIME_DIR, exist_ok=True)
    path = os.path.join(CHECK_TIME_DIR, f"{local_rank}.json")
    record = {"elapsed": elapsed, "normal": normal, "ts": time.time()}
    if legs:
        record["legs"] = legs
    with open(path, "w") as f:
        json.dump(record, f)


def read_time_from_file(local_rank: int = 0):
    path = os.path.join(CHECK_TIME_DIR, f"{local_rank}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def run_node_check(local_rank: int = 0, device: str = "cuda",
                   nprocs: int = 1) -> tuple[bool, float]:
    """The payload the agent executes, over ``nprocs`` local ranks in
    child processes on ``device`` ("cuda", or "cpu" when the caller asks
    for it). Returns (normal, elapsed_seconds); the legs of local rank 0
    go to the per-rank file beside them."""
    start = time.time()
    normal = True
    legs: dict = {}
    try:
        if _mock_error():
            raise RuntimeError("mock node failure injected via MOCK_ERR_RANK")
        legs = _legs_in_children(device, nprocs)
    except Exception as e:  # noqa: BLE001 - a failed probe is a verdict
        logger.error("node check failed: %s", e)
        normal = False
    elapsed = time.time() - start
    write_time_to_file(elapsed, normal, local_rank, legs)
    logger.info("node check: normal=%s elapsed=%.2fs legs=%s", normal,
                elapsed, json.dumps(legs))
    return normal, elapsed


def main(argv=None):
    """``--child RANK WORLD INIT_METHOD DEVICE``: one local rank of the
    probe (the agent's child); without it, the whole check on the card
    (exit 1 when it fails)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        rank, world, init, device = argv[1:5]
        legs = _child(int(rank), int(world), init, device)
        print(_CHILD_TAG + json.dumps(legs), flush=True)
        raise SystemExit(0)
    normal, _elapsed = run_node_check(
        int(os.environ.get(NodeEnv.LOCAL_RANK, "0"))
    )
    raise SystemExit(0 if normal else 1)


if __name__ == "__main__":
    main()

"""``tpu-run``: the elastic training launcher CLI.

Equivalent capability: reference dlrover/trainer/torch/elastic_run.py —
a torchrun superset with --network-check --node-unit --auto-config
--auto-tunning --exclude-straggler --save-at-breakpoint (:124-179), local
master spawning when none exists (:230), and master reachability check
(:258). Here the launched workers are torch processes, one per card,
supervised by agent/training_agent.ElasticTrainingAgent.

The PyTorch port's copy of dlrover_tpu/trainer/run.py (console script
``tpu-run-torch``): ``--accelerator`` defaults to ``gpu``, the local
master is ``dlrover_tpu_torch.master.main``, and
``--compilation-cache-dir`` is the kernel build directory the workers
share across restarts.

Usage:
    python -m dlrover_tpu_torch.trainer.run [--nnodes N] [--nproc_per_node M] \
        [--max-restarts R] script.py [script args...]
"""

from __future__ import annotations

import argparse
import atexit
import os
import subprocess
import sys
import time

from dlrover_tpu_torch.agent.training_agent import (
    ElasticLaunchConfig,
    launch_agent,
)
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.rpc import addr_connectable, find_free_port

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="tpu-run-torch",
        description="dlrover_tpu_torch elastic launcher"
    )
    parser.add_argument("--nnodes", type=str, default="1")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=None)
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument(
        "--network-check",
        action="store_true",
        help="run the node check (matmul and NCCL collectives on the "
             "cards, in child processes) before training",
    )
    parser.add_argument(
        "--comm-perf-test", action="store_true",
        help="also benchmark collective bandwidth in the check",
    )
    parser.add_argument("--node-unit", type=int, default=1)
    parser.add_argument("--auto-config", action="store_true")
    parser.add_argument("--auto-tunning", action="store_true")
    parser.add_argument("--exclude-straggler", action="store_true")
    parser.add_argument("--save-at-breakpoint", action="store_true")
    parser.add_argument("--accelerator", type=str, default="gpu")
    parser.add_argument("--rdzv-timeout", type=float, default=600)
    parser.add_argument(
        "--rdzv-elastic-wait", type=float, default=30,
        help="with --nnodes lo:hi, how long to wait for nodes beyond "
             "min before forming the world",
    )
    parser.add_argument("--log-dir", type=str, default=None)
    parser.add_argument(
        "--metrics-port", type=int, default=-1,
        help="Prometheus /metrics port on the agent "
             "(-1 = disabled [default], 0 = ephemeral, >0 = fixed)",
    )
    parser.add_argument(
        "--compilation-cache-dir",
        type=str,
        default=os.environ.get("DLROVER_TORCH_KERNEL_CACHE", ""),
        help="the kernel build directory the workers share across "
             "restarts (a restarted worker loads its kernels instead of "
             "building them); '' = the package's own ops/build/",
    )
    parser.add_argument("training_script", type=str)
    parser.add_argument(
        "training_script_args", nargs=argparse.REMAINDER
    )
    return parser.parse_args(argv)


def _parse_nnodes(nnodes: str) -> tuple[int, int]:
    if ":" in nnodes:
        lo, _, hi = nnodes.partition(":")
        return int(lo), int(hi)
    n = int(nnodes)
    return n, n


def _launch_local_master(node_num: int) -> tuple[subprocess.Popen, str]:
    """Spawn a local master subprocess (reference
    _launch_dlrover_local_master :230)."""
    port = find_free_port()
    # spawn seam (dlint DL003): agent.spawn covers workers; this is
    # the master-process counterpart
    chaos_point("master.spawn", port=port)
    proc = subprocess.Popen(  # noqa: S603
        [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.master.main",
            "--platform",
            "local",
            "--port",
            str(port),
            "--node_num",
            str(node_num),
        ],
        stdout=subprocess.DEVNULL,
        stderr=None,
    )
    addr = f"127.0.0.1:{port}"
    for _ in range(60):
        if addr_connectable(addr):
            break
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
        time.sleep(0.5)
    else:
        raise RuntimeError(f"local master not reachable at {addr}")
    atexit.register(proc.terminate)
    return proc, addr


def run(args) -> int:
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    node_rank = (
        args.node_rank
        if args.node_rank is not None
        else int(os.environ.get(NodeEnv.NODE_RANK, "0"))
    )
    master_addr = os.environ.get(NodeEnv.DLROVER_MASTER_ADDR, "")
    master_proc = None
    if not master_addr or not addr_connectable(master_addr):
        if master_addr:
            logger.warning(
                "master %s not reachable; starting a local one", master_addr
            )
        if node_rank == 0:
            master_proc, master_addr = _launch_local_master(min_nodes)
            os.environ[NodeEnv.DLROVER_MASTER_ADDR] = master_addr
        else:
            raise RuntimeError(
                "DLROVER_MASTER_ADDR is required on non-zero node ranks"
            )
    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        node_rank=node_rank,
        max_restarts=args.max_restarts,
        network_check=args.network_check,
        comm_perf_test=args.comm_perf_test,
        node_unit=args.node_unit,
        auto_config=args.auto_config,
        auto_tunning=args.auto_tunning,
        exclude_straggler=args.exclude_straggler,
        save_at_breakpoint=args.save_at_breakpoint,
        accelerator=args.accelerator,
        rdzv_timeout=args.rdzv_timeout,
        rdzv_elastic_wait=args.rdzv_elastic_wait,
        log_dir=args.log_dir,
        compilation_cache_dir=args.compilation_cache_dir,
        metrics_port=args.metrics_port,
    )
    script_args = list(args.training_script_args)
    if script_args and script_args[0] == "--":
        script_args = script_args[1:]
    try:
        return launch_agent(
            config, args.training_script, tuple(script_args), master_addr
        )
    finally:
        if master_proc is not None and master_proc.poll() is None:
            master_proc.terminate()


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())

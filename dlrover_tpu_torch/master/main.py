"""Master process entry: ``python -m dlrover_tpu_torch.master.main``.

Equivalent capability: reference dlrover/python/master/main.py:44 run()
which picks LocalJobMaster vs DistributedJobMaster by platform.

The PyTorch port's copy of dlrover_tpu/master/main.py.
"""

from __future__ import annotations

import argparse
import os
import sys

from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import PlatformType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.master import (
    DistributedJobMaster,
    LocalJobMaster,
)
from dlrover_tpu_torch.scheduler.job import new_job_args

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="dlrover_tpu_torch job master")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument(
        "--platform",
        type=str,
        default=PlatformType.LOCAL,
        choices=[
            PlatformType.LOCAL,
            PlatformType.KUBERNETES,
            PlatformType.RAY,
        ],
    )
    parser.add_argument("--job_name", type=str, default="dlrover-tpu-job")
    parser.add_argument("--namespace", type=str, default="default")
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument(
        "--relaunch_on_worker_failure", type=int, default=3
    )
    parser.add_argument(
        "--state-dir", type=str, default="",
        help="persist control-plane state (rendezvous, shard progress, "
        "kv-store, barriers) here so a restarted master can resume",
    )
    parser.add_argument(
        "--restore-state", type=str, default="", metavar="DIR",
        help="restore control-plane state from DIR (implies "
        "--state-dir DIR); with --port 0 the previous port is re-bound "
        "so agents and workers reconnect without re-resolution",
    )
    parser.add_argument(
        "--addr-file", type=str, default="",
        help="write the bound host:port here (atomically); agents "
        "re-read it via DLROVER_MASTER_ADDR_FILE when reconnecting",
    )
    parser.add_argument(
        "--http-port", type=int,
        default=int(os.environ.get("DLROVER_MASTER_HTTP_PORT", "-1")),
        help="serve the read-only live-metrics HTTP plane (/metrics "
        "Prometheus page, /report.json, /series.json, HTML dashboard "
        "at /) on this port; 0 = ephemeral, -1 = disabled (default)",
    )
    return parser.parse_args(argv)


def run(args) -> int:
    import signal

    from dlrover_tpu_torch.common import telemetry

    if telemetry.active_registry() is not None:
        # label this process's snapshots as the master (the registry
        # was created at import, before we knew the role)
        os.environ.setdefault(telemetry.ENV_ROLE, "master")
        telemetry.enable()
    def _terminate(signum, frame):  # noqa: ARG001
        raise SystemExit(143)

    try:
        # tpu-run stops this subprocess with SIGTERM; the default
        # handler exits without finally/atexit, silently dropping the
        # master's telemetry (rendezvous events) and the clean stop().
        # Raising SystemExit runs both.
        signal.signal(signal.SIGTERM, _terminate)
    except ValueError:
        pass  # not the main thread (embedded use)
    job_args = new_job_args(
        args.platform,
        args.job_name,
        args.namespace,
        node_num=args.node_num,
        relaunch_on_worker_failure=args.relaunch_on_worker_failure,
    )
    state_dir = args.restore_state or args.state_dir
    restore = bool(args.restore_state)
    port = args.port
    if restore and port == 0:
        # re-bind the previous incarnation's port so every cached
        # worker/agent connection target stays valid across the failover
        from dlrover_tpu_torch.master.state_store import MasterStateStore

        port = MasterStateStore.peek_port(state_dir)
    http_port = args.http_port if args.http_port >= 0 else None
    if args.platform == PlatformType.LOCAL:
        master = LocalJobMaster(
            port, job_args, state_dir=state_dir, restore_state=restore,
            http_port=http_port,
        )
    else:
        scaler = watcher = None
        if args.platform == PlatformType.KUBERNETES:
            from dlrover_tpu_torch.scheduler.kubernetes import (
                new_pod_scaler_and_watcher,
            )

            scaler, watcher = new_pod_scaler_and_watcher(job_args)
        master = DistributedJobMaster(
            port, job_args, scaler=scaler, watcher=watcher,
            state_dir=state_dir, restore_state=restore,
            http_port=http_port,
        )
    master.prepare()
    if master.http_plane is not None:
        # discoverable like the RPC addr below: the dashboard/scrape
        # target for whatever launched this master
        print(
            f"DLROVER_MASTER_HTTP=127.0.0.1:{master.http_plane.port}",
            flush=True,
        )
    addr = f"127.0.0.1:{master.port}"
    if args.addr_file:
        # the addr file is how agents re-resolve a restarted master
        # (dlint DL003): a schedule can delay/error the publish to
        # exercise the ride-through window
        chaos_point("master.addrfile", addr=addr)
        tmp = f"{args.addr_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(addr)
        os.replace(tmp, args.addr_file)
    # Print the bound address so a parent (tpu-run) can discover the port.
    print(f"DLROVER_MASTER_ADDR={addr}", flush=True)
    return master.run()


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())

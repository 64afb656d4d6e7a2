"""The worker's progress file for the agent (a copy of
``write_runtime_metrics`` from dlrover_tpu/agent/monitor.py; the rest of
that module reads device stats through jax and waits for the agent's
port, ROADMAP Queue 1 item 6)."""

from __future__ import annotations

import json
import os
import time

from dlrover_tpu_torch.common.constants import ConfigPath


def write_runtime_metrics(step: int, **extra):
    """Called from the training loop (worker side) to publish progress."""
    path = os.environ.get(
        ConfigPath.ENV_RUNTIME_METRICS, ConfigPath.RUNTIME_METRICS
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"step": step, "timestamp": time.time(), **extra}, f)
    os.replace(tmp, path)

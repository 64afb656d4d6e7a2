"""Agent <-> worker signaling for restart-free elastic mesh reshapes.

Equivalent capability: the reference restarts worker processes on every
membership change (training.py:602 ``_membership_changed`` ->
``_restart_workers``).  Here a membership change where the host survives
is signaled INTO the live worker instead: the agent writes a
:class:`ReshapeRequest` file, the worker's trainer drains the current
step, rebuilds the mesh in process, reshards its state device-to-device
(checkpoint fallback only for shards whose owners died), and acks — no
process kill, no full recompile (the persistent XLA cache warms the new
step), no full restore.

The channel is a pair of atomically-replaced JSON files under a
directory the agent exports as ``NodeEnv.RESHAPE_DIR``:

- ``ready.json``     worker -> agent: "I run a reshape watcher" —
  written when the trainer installs its watcher.  The agent signals a
  reshape ONLY when every local worker advertised readiness; bare
  workers (no watcher) keep the classic restart path, so the feature is
  opt-in by worker capability, not by configuration.
- ``request.json``   agent -> worker: the new round (world, rank
  offset, coordinator, who departed and HOW — "drained" hosts were
  alive at the drain point, "dead" hosts took their shards with them).
- ``ack.json``       worker -> agent: per-round outcome + stats.  A
  missing or failed ack (worker killed mid-reshape, incompatible mesh)
  makes the agent fall back to the restart path.

Fault sites: ``elastic.signal`` (the agent-side request write) and
``elastic.reshape`` with ``verb`` = ``drain`` | ``reshard`` | ``resume``
| ``ack`` (the worker-side seams) — a kill injected at any of them must
recover via the restart path without losing or double-serving a
dataset shard.

The PyTorch port's copy of dlrover_tpu/trainer/elastic/reshape.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_READY_FILE = "ready.json"
_REQUEST_FILE = "request.json"
_ACK_FILE = "ack.json"


@dataclasses.dataclass
class ReshapeRequest:
    """One membership change, as handed to a surviving worker."""

    round: int = 0
    # node_rank -> local_world_size of the NEW world
    world: dict = dataclasses.field(default_factory=dict)
    rank_offset: int = 0
    total: int = 1
    coordinator: str = ""
    # node_rank -> "dead" | "drained" for ranks that left the round
    departed: dict = dataclasses.field(default_factory=dict)
    # optional explicit device count for the new mesh (0 = worker
    # decides; single-host tests emulate scale with device subsets)
    device_count: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: dict) -> "ReshapeRequest":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in payload.items() if k in fields}
        kw["world"] = {
            int(r): int(v) for r, v in (kw.get("world") or {}).items()
        }
        kw["departed"] = {
            int(r): str(v)
            for r, v in (kw.get("departed") or {}).items()
        }
        return cls(**kw)


def _write_atomic(path: str, payload: dict):
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
        # a torn read races the atomic replace only on exotic
        # filesystems; treat like "not there yet" and re-poll
        return None


class ReshapeChannel:
    """Both halves of the file channel (the agent constructs one per
    local worker; the worker constructs one from ``NodeEnv.RESHAPE_DIR``)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------- worker side

    def mark_ready(self):
        """Advertise that a reshape watcher is polling this channel.
        Until this exists the agent keeps the classic restart path."""
        chaos_point("elastic.reshape", verb="ready")
        _write_atomic(
            os.path.join(self.directory, _READY_FILE),
            {"pid": os.getpid(), "t": time.time()},
        )

    def poll(self, last_round: int) -> ReshapeRequest | None:
        """A new request (round > ``last_round``) or None.  Cheap: one
        stat + read only when the file exists."""
        payload = _read_json(
            os.path.join(self.directory, _REQUEST_FILE)
        )
        if not payload:
            return None
        req = ReshapeRequest.from_json(payload)
        if req.round <= last_round:
            return None
        return req

    def ack(self, round_: int, ok: bool, **stats):
        chaos_point("elastic.reshape", verb="ack", round=round_)
        _write_atomic(
            os.path.join(self.directory, _ACK_FILE),
            {"round": int(round_), "ok": bool(ok), "t": time.time(),
             **stats},
        )

    # -------------------------------------------------------- agent side

    def worker_ready(self) -> bool:
        return os.path.exists(
            os.path.join(self.directory, _READY_FILE)
        )

    def signal(self, request: ReshapeRequest):
        """Hand the new round to the worker (atomic replace: the worker
        only ever reads a complete request)."""
        # the signal write is the agent half of the reshape seam
        # (worker half: elastic.reshape) — a dropped/killed signal must
        # degrade to the restart path
        chaos_point("elastic.signal", round=request.round)
        _write_atomic(
            os.path.join(self.directory, _REQUEST_FILE),
            request.to_json(),
        )

    def read_ack(self, round_: int) -> dict | None:
        payload = _read_json(os.path.join(self.directory, _ACK_FILE))
        if payload and int(payload.get("round", -1)) == int(round_):
            return payload
        return None

    def await_ack(
        self, round_: int, timeout: float, alive_fn=None,
        poll: float = 0.1,
    ) -> dict | None:
        """Wait for the worker's ack of ``round_``.  Returns the ack
        payload, or None on timeout / worker death (``alive_fn``
        returning False) — both mean: fall back to the restart path."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            ack = self.read_ack(round_)
            if ack is not None:
                return ack
            if alive_fn is not None and not alive_fn():
                logger.warning(
                    "worker died while a round-%s reshape was in "
                    "flight", round_,
                )
                return None
            time.sleep(poll)
        return None

    def clear(self):
        """Drop any stale request/ack (fresh worker incarnation)."""
        for name in (_REQUEST_FILE, _ACK_FILE, _READY_FILE):
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass

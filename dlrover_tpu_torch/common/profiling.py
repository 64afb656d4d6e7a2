"""The agent <-> worker deep-capture channel of the profiling plane: a
copy of ``ENV_CAPTURE_DIR``, ``CaptureRequest`` and ``CaptureChannel``
from dlrover_tpu/common/profiling.py, which the agent's ``_worker_env``
sets up for every worker. The rest of that module (the device-time
sampler and the capture itself) is not ported yet (ROADMAP Queue 1
item 12): a capture directive that reaches the port's agent is acked as
failed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from dlrover_tpu_torch.common.chaos import chaos_point

ENV_CAPTURE_DIR = "DLROVER_PROF_CAPTURE_DIR"
DEFAULT_CAPTURE_STEPS = 2

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
    ``DLROVER_PROF_CAPTURE_DIR``)."""

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

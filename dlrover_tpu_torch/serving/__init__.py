"""Elastic inference serving arm of the PyTorch port: continuous-batching
decode under the training control plane (port of dlrover_tpu/serving).

- :mod:`engine`    — slotted KV-cache pool, the bucketed slot prefill and
  the mixed-slot decode step (one CUDA graph on the card);
- :mod:`scheduler` — continuous batching over the slot map (admit /
  decode / evict every step);
- :mod:`manager`   — master-side request ledger (lease, exactly-once
  re-queue, never-silently-dropped);
- :mod:`worker`    — one decode-pool member under the existing master
  (rendezvous, telemetry shipping, chaos seams);
- :mod:`loadgen`   — seeded Poisson load + the headline serve_* keys.

Attribute access is lazy: the master imports :mod:`manager` (pure
stdlib) without importing torch, which it never uses.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "DecodeEngine": "engine",
    "SlotKVCache": "engine",
    "bucket_len": "engine",
    "init_slot_cache": "engine",
    "slot_decode": "engine",
    "slot_prefill": "engine",
    "make_requests": "loadgen",
    "percentile": "loadgen",
    "poisson_arrivals": "loadgen",
    "run_open_loop": "loadgen",
    "summarize": "loadgen",
    "ServingRequestManager": "manager",
    "ContinuousBatchingScheduler": "scheduler",
    "FinishedSequence": "scheduler",
    "ServeRequest": "scheduler",
    "DecodeWorker": "worker",
    "LocalServingClient": "worker",
    "RpcServingClient": "worker",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    mod = importlib.import_module(f"{__name__}.{module}")
    return getattr(mod, name)

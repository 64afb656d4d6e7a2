"""ShmDataLoader: a cross-process batch pipeline over shared memory
(port of dlrover_tpu/trainer/elastic/shm_loader.py, wire format and
names unchanged: a batch one package's writer puts decodes in the other
package's loader).

CPU preprocessing runs in separate processes and hands finished batches
to the training process through shared memory, so the input pipeline
never shares the trainer's GIL. A slab of ``slots`` fixed-size segments
plus two SharedQueues (free / filled): producers pop a free slot,
serialize the batch into it (numpy arrays as raw bytes behind a small
pickled header) and push (slot, nbytes) to the filled queue; the
consumer yields the decoded batch and recycles the slot. Backpressure is
the free queue running dry.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np

from dlrover_tpu_torch.common.ipc import SharedQueue, get_or_create_shm
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_LEN = 8  # uint64 payload length prefix


def _encode(batch) -> bytes:
    """Pickle the structure but keep ndarray payloads as raw buffers."""
    arrays: list[np.ndarray] = []

    def strip(x):
        if isinstance(x, np.ndarray):
            arrays.append(np.ascontiguousarray(x))
            return ("__nd__", len(arrays) - 1, x.dtype.str, x.shape)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x

    tree = strip(batch)
    head = pickle.dumps((tree, [a.nbytes for a in arrays]))
    parts = [struct.pack("<Q", len(head)), head]
    parts.extend(a.tobytes() for a in arrays)
    return b"".join(parts)


def _decode(buf: memoryview):
    head_len = struct.unpack("<Q", bytes(buf[:_LEN]))[0]
    tree, sizes = pickle.loads(bytes(buf[_LEN:_LEN + head_len]))
    offset = _LEN + head_len
    arrays = []
    for n in sizes:
        arrays.append(bytes(buf[offset:offset + n]))
        offset += n

    def rebuild(x):
        if isinstance(x, tuple) and len(x) == 4 and x[0] == "__nd__":
            _, idx, dtype, shape = x
            return np.frombuffer(
                arrays[idx], dtype=np.dtype(dtype)
            ).reshape(shape)
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)


class _Slab:
    def __init__(self, name: str, slots: int, slot_bytes: int):
        self.slots = slots
        self.slot_bytes = slot_bytes
        self._shm = get_or_create_shm(
            f"dlrtpu_batch_{name}", slots * slot_bytes
        )

    def view(self, slot: int) -> memoryview:
        start = slot * self.slot_bytes
        return self._shm.buf[start:start + self.slot_bytes]

    def close(self, unlink: bool = False):
        self._shm.close()
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


_END = ("__end__",)


class ShmBatchWriter:
    """Producer side (run in the preprocessing process)."""

    def __init__(self, name: str, slots: int = 8,
                 slot_bytes: int = 64 << 20, create: bool = True):
        self._slab = _Slab(name, slots, slot_bytes)
        self._owns_queues = create
        self._free = SharedQueue(f"batchfree_{name}", create=create)
        self._filled = SharedQueue(f"batchfill_{name}", create=create)
        if create:
            for slot in range(slots):
                self._free.put(slot)

    def put(self, batch, timeout: float | None = None):
        payload = _encode(batch)
        if len(payload) > self._slab.slot_bytes:
            raise ValueError(
                f"batch of {len(payload)} bytes exceeds slot size "
                f"{self._slab.slot_bytes}; raise slot_bytes"
            )
        slot = self._free.get(timeout=timeout)
        view = self._slab.view(slot)
        view[: len(payload)] = payload
        self._filled.put((slot, len(payload)))

    def end(self):
        """Signal end-of-data to the consumer."""
        self._filled.put(_END)

    def close(self, unlink: bool = False):
        # creator side also tears down the queue socket servers so a
        # later session with the same name starts fresh
        if self._owns_queues:
            for q in (self._free, self._filled):
                try:
                    q.unlink()
                except Exception:  # noqa: BLE001
                    pass
        self._slab.close(unlink=unlink)


class ShmDataLoader:
    """Consumer side (the training process): iterate decoded batches."""

    def __init__(self, name: str, slots: int = 8,
                 slot_bytes: int = 64 << 20):
        self._name = name
        self._slab = _Slab(name, slots, slot_bytes)
        self._free = SharedQueue(f"batchfree_{name}")
        self._filled = SharedQueue(f"batchfill_{name}")

    def __iter__(self):
        while True:
            item = self._filled.get()
            if item == _END:
                return
            slot, nbytes = item
            view = self._slab.view(slot)
            batch = _decode(view[:nbytes])
            # _decode copies payload bytes out of shm: recycling the
            # slot immediately is safe
            self._free.put(slot)
            yield batch

    def close(self, unlink: bool = False):
        self._slab.close(unlink=unlink)

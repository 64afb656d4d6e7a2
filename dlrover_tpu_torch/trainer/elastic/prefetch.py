"""DevicePrefetcher: overlap the host -> device copy of the next batches
with compute (port of dlrover_tpu/trainer/elastic/prefetch.py).

On ``cuda`` each host batch is staged in pinned memory and copied on a
side stream with ``non_blocking=True``, ``depth`` batches ahead of the
one the consumer is using. Before a batch is handed out, the consumer's
stream waits for that batch's copy (an event), and each of its tensors
is marked used on the consumer's stream (``record_stream``), so that the
caching allocator does not give its memory to the side stream's next
copies while the step still reads it. A pinned staging buffer is refilled
only after its previous copy's event has completed: an async copy from a
buffer overwritten too early would land a wrong batch, not an error.

``device_mesh`` (the JAX package's ``sharding``) turns each leaf, this
rank's rows, into a DTensor over the mesh: rows split over the batch
axes, replicated over the rest, as the train step places a batch.

On a CPU device, which the caller asked for, batches pass through as
tensors. A ``cuda`` device without CUDA raises: the prefetcher never
falls back to the CPU on its own.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dlrover_tpu_torch.device import resolve_device


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif _is_array(tree):
        out.append(tree)
    return out


def _rebuild(tree, it):
    """``tree`` with each array leaf replaced by the next of ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it) if _is_array(tree) else tree


class _Staging:
    """One batch's pinned host buffers and the event of its last copy."""

    def __init__(self):
        self.buffers: list = []
        self.event = None

    def fill(self, leaves) -> list:
        if self.event is not None:
            # the previous async copy out of these buffers must have
            # landed before they are written again
            self.event.synchronize()
        out = []
        for i, leaf in enumerate(leaves):
            # a numpy leaf (read-only, as a decoded shm batch is) is copied
            # through the buffer's numpy view
            dtype = (leaf.dtype if isinstance(leaf, torch.Tensor) else
                     torch.from_numpy(np.empty(0, leaf.dtype)).dtype)
            buf = self.buffers[i] if i < len(self.buffers) else None
            if buf is None or buf.shape != leaf.shape or buf.dtype != dtype:
                buf = torch.empty(leaf.shape, dtype=dtype, pin_memory=True)
                if i < len(self.buffers):
                    self.buffers[i] = buf
                else:
                    self.buffers.append(buf)
            if isinstance(leaf, torch.Tensor):
                buf.copy_(leaf)
            else:
                np.copyto(buf.numpy(), leaf)
            out.append(buf)
        del self.buffers[len(leaves):]
        return out


class DevicePrefetcher:
    """Wraps a host-batch iterable; yields device-resident batches.

    A batch is an array or a dict/list/tuple tree of them (numpy or CPU
    tensors); other leaves pass through unchanged. ``device``: ``cuda``
    unless the caller asks for the CPU. ``copy_ms()`` gives each batch's
    copy time on the side stream (CUDA events around its copies).
    """

    def __init__(self, iterable, device=None, depth: int = 2,
                 device_mesh=None):
        self._iterable = iterable
        self.device = resolve_device(device)
        self._depth = max(1, int(depth))
        self._mesh = device_mesh
        self._stream = None
        self._staging = [_Staging() for _ in range(self._depth + 1)]
        # (start, done) events of the newest copies
        self._timings: collections.deque = collections.deque(maxlen=4096)
        self._issued = 0

    # ------------------------------------------------------------ copies

    def _place(self, tensors: list) -> list:
        if self._mesh is None:
            return tensors
        from torch.distributed.tensor import DTensor

        from dlrover_tpu_torch.parallel.accelerate import _batch_placements

        placements = _batch_placements(self._mesh)
        return [DTensor.from_local(t, self._mesh, placements,
                                   run_check=False) for t in tensors]

    def _put(self, batch):
        """Start ``batch``'s copy; returns (batch tree, tensors, event)."""
        leaves = _leaves(batch, [])
        if self.device.type == "cpu":
            out = [torch.as_tensor(x) for x in leaves]
            return batch, out, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        staging = self._staging[self._issued % len(self._staging)]
        self._issued += 1
        host = staging.fill(leaves)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record(self._stream)
            out = [h.to(self.device, non_blocking=True) for h in host]
            done.record(self._stream)
        staging.event = done
        self._timings.append((start, done))
        return batch, out, done

    def _hand_out(self, item):
        batch, tensors, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in tensors:
                t.record_stream(consumer)
        return _rebuild(batch, iter(self._place(tensors)))

    def copy_ms(self) -> list:
        """Each batch's copy ms on the side stream (synchronizes)."""
        out = []
        for start, done in self._timings:
            done.synchronize()
            out.append(start.elapsed_time(done))
        return out

    # --------------------------------------------------------- iteration

    def __iter__(self):
        # fresh iterator per epoch, so the wrapper is re-iterable (and the
        # underlying loader's per-epoch hot-reconfig re-runs)
        it = iter(self._iterable)
        queue: collections.deque = collections.deque()
        try:
            while len(queue) < self._depth:
                queue.append(self._put(next(it)))
        except StopIteration:
            pass
        while queue:
            out = queue.popleft()
            try:
                queue.append(self._put(next(it)))
            except StopIteration:
                pass
            yield self._hand_out(out)

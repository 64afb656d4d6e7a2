"""Collective–compute overlap for the fsdp layer loop (port of
dlrover_tpu/parallel/overlap.py).

Equivalent capability: DeepSpeed/FSDP prefetch and the Megatron
overlapped-collective schedules: layer *k+1*'s param all-gather runs
while layer *k* computes, and layer *k*'s grad reduce-scatter hides
behind the backward of the layers before it.

The models gather each layer's fsdp shards at its start
(parallel/shard_ops.py), so the gather and the layer's first matmul
serialise. Under ``Strategy.overlap_collectives`` the layer loop takes
its gathers from :func:`layer_gather_fn` instead, which issues layer
*k+1*'s gathers before layer *k* computes and waits for layer *k*'s
only where it uses them:

- ``"xla"``: ``all_gather_into_tensor(async_op=True)``. The wait is a
  stream wait on NCCL (the compute stream waits for the collective, the
  host does not); on gloo the collective runs on gloo's threads and the
  wait blocks the host.
- ``"manual"``: the ring of ``ops/collectives.py``, N-1 hops. On a card
  they run on a side stream, which the compute stream waits for through
  an event; on gloo they run when issued.

In both modes the gather's backward reduce-scatters asynchronously the
same way (the library's ``reduce_scatter_tensor``, or the ring), and
nothing reads a reduced gradient before it has landed: the layer stack's
unbind takes the gradients of every layer in one backward node, which
waits for every pending reduce-scatter before it stacks them, and the
step waits once more (:func:`wait_pending`) before it settles the
gradients and steps the optimizer.

Under remat a checkpointed layer gathers again in its recompute, as the
JAX package's gather inside the scan body does: the prefetched result is
taken once, and a recompute, which finds none, gathers then
(:meth:`LayerGather._regather`). A checkpoint around the whole loop
(``Strategy.remat``) recomputes under the forward's mode
(parallel/remat.py restores it), so its recompute prefetches again.

The mode is an ambient flag (``overlap_autocast``), set by
``auto_accelerate`` around each microbatch's forward from the Strategy,
so model code never threads it; the effective rule table rides along
(:func:`overlap_rules`), as in the JAX package. Here the gather plan is
read off the params' placements, which the rule table made.
:func:`layer_gather_fn` returns None (the plain gathers) when the mode
is off, there is no DeviceMesh, or ``fsdp`` is 1.

The JAX package's ``latency_hiding_flags`` are XLA scheduler flags; the
port has no counterpart: its overlap is the explicit issue order above.

On gloo ``"xla"`` is bit-equal to ``"off"`` (the same collectives);
``"manual"`` gathers exactly but sums the reduce-scatter in the ring's
order, so its gradients may differ from ``"off"``'s in the last bits.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops import collectives

__all__ = ["OVERLAP_MODES", "LayerGather", "layer_gather_fn",
           "overlap_autocast", "overlap_mode", "overlap_rules",
           "wait_pending"]

OVERLAP_MODES = ("off", "xla", "manual")

# the mesh axis the overlap decomposes (the ZeRO-3 param/grad axis)
_GATHER_AXIS = "fsdp"


class _Flag:
    mode: str = "off"
    rules = None  # the effective logical rules the params were laid with


def overlap_mode() -> str:
    """The active collective-overlap mode."""
    return _Flag.mode


def overlap_rules():
    """The effective rule table ``overlap_autocast`` carries (None: the
    default table)."""
    return _Flag.rules


def capture() -> tuple:
    """The active (mode, rules): ``overlap_autocast(*capture())`` makes
    them active again (a checkpoint's recompute, which runs after the
    forward's autocast has exited, must run the forward's gathers)."""
    return _Flag.mode, _Flag.rules


@contextlib.contextmanager
def overlap_autocast(mode: str = "xla", rules=None):
    """While active, the layer loops double-buffer their fsdp gathers
    (``mode`` "xla" or "manual"; "off" leaves them plain). ``rules`` is
    the effective rule table the params were placed with."""
    if mode not in OVERLAP_MODES:
        raise ValueError(
            f"overlap mode must be one of {OVERLAP_MODES}, got {mode!r}")
    prev, prev_rules = _Flag.mode, _Flag.rules
    _Flag.mode, _Flag.rules = mode, rules
    try:
        yield
    finally:
        _Flag.mode, _Flag.rules = prev, prev_rules


# ---------------------------------------------------------------- waiters

# the reduce-scatters issued by backward passes and not yet waited for
_PENDING: list = []


class _Done:
    """A collective that ran when it was issued."""

    @staticmethod
    def wait():
        return None


class _StreamEvent:
    """Work on a side stream: :meth:`wait` makes the current stream wait
    for it (no host sync)."""

    def __init__(self, event):
        self.event = event

    def wait(self):
        torch.cuda.current_stream().wait_event(self.event)


_SIDE_STREAMS: dict = {}


def _on_side(device, fn, tensors):
    """Run ``fn`` on the device's side stream after what the current
    stream has issued, and return its waiter; on the CPU run it now.
    ``tensors`` (made on the current stream, used by ``fn``) are marked
    used on the side stream, so their memory outlives its work."""
    if device.type != "cuda":
        fn()
        return _Done()
    side = _SIDE_STREAMS.get(device)
    if side is None:
        side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
        event = torch.cuda.Event()
        event.record(side)
    for t in tensors:
        t.record_stream(side)
    return _StreamEvent(event)


def _issue_gather(out, src, group, mode):
    """Start gathering ``src`` along dim 0 over ``group`` into ``out``;
    returns its waiter."""
    if mode == "xla":
        return dist.all_gather_into_tensor(out, src, group=group,
                                           async_op=True)
    return _on_side(src.device,
                    lambda: collectives.gather_into(out, src, group),
                    (out, src))


def _issue_reduce_scatter(out, src, group, mode):
    """Start reduce-scattering ``src`` along dim 0 over ``group`` into
    ``out``; returns its waiter."""
    if mode == "xla":
        return dist.reduce_scatter_tensor(out, src, group=group,
                                          async_op=True)
    return _on_side(
        src.device,
        lambda: out.copy_(collectives.reduce_scatter(src, group)),
        (out, src))


def wait_pending() -> None:
    """Wait for every reduce-scatter the backward passes issued."""
    while _PENDING:
        _PENDING.pop(0).wait()


class _GatherStart(torch.autograd.Function):
    """Issue the all-gather of ``x`` along ``dim`` (moved to dim 0);
    returns the buffer it fills and appends its waiter to ``box``. The
    backward issues the reduce-scatter of the gradient and leaves its
    waiter pending."""

    @staticmethod
    def forward(ctx, x, dim, group, mode, box):
        ctx.dim, ctx.group, ctx.mode = dim, group, mode
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((dist.get_world_size(group) * src.shape[0],)
                          + tuple(src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        box.append(_issue_gather(out, src, group, mode))
        return out

    @staticmethod
    def backward(ctx, grad):
        src = grad.contiguous()
        out = torch.empty((src.shape[0] // dist.get_world_size(ctx.group),)
                          + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        _PENDING.append(_issue_reduce_scatter(out, src, ctx.group,
                                              ctx.mode))
        return out.movedim(0, ctx.dim), None, None, None, None


class _GatherWait(torch.autograd.Function):
    """Wait for the gather whose waiter ``box`` holds; the identity for
    the gradient."""

    @staticmethod
    def forward(ctx, buf, box):
        box.pop().wait()
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Unbind(torch.autograd.Function):
    """``x.unbind(0)`` whose backward waits for every pending
    reduce-scatter before it stacks the slices' gradients."""

    @staticmethod
    def forward(ctx, x):
        return tuple(t.view_as(t) for t in x.unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        wait_pending()
        return torch.stack(grads)


class LayerGather:
    """The fsdp gathers of one forward's layers, each issued one layer
    ahead. ``gathers`` maps each stacked param's key to its gathers
    (``ShardContext.gathers``); a param whose first gather is over
    ``fsdp`` has that gather prefetched, the rest gathers plainly when
    used, and a checkpointed layer's recompute gathers again."""

    def __init__(self, ctx, gathers: dict, mode: str):
        self.ctx, self.gathers, self.mode = ctx, gathers, mode
        self.group = ctx.mesh.get_group(_GATHER_AXIS)
        self._issued: dict = {}

    def split(self, stacks: dict) -> dict:
        """Each stack's layers (``unbind(0)``), the gradients of which
        are read only after every pending reduce-scatter landed."""
        return {k: _Unbind.apply(v) for k, v in stacks.items()}

    def _prefetch(self, i: int, layers: dict) -> None:
        for k, x in layers.items():
            todo = self.gathers[k]
            if (i, k) in self._issued or not todo or (
                    todo[0][0] != _GATHER_AXIS):
                continue
            box: list = []
            buf = _GatherStart.apply(x, todo[0][1], self.group, self.mode,
                                     box)
            self._issued[i, k] = (buf, box)

    def layer(self, i: int, stacks: dict):
        """Issue layer ``i``'s gathers (if not yet) and layer ``i + 1``'s,
        then return layer ``i``'s ``gather(key, local) -> whole``."""
        for j in (i, i + 1):
            if j < len(next(iter(stacks.values()))):
                self._prefetch(j, {k: v[j] for k, v in stacks.items()})
        return functools.partial(self._take, i)

    def _take(self, i: int, key: str, x):
        todo = self.gathers[key]
        if not todo or todo[0][0] != _GATHER_AXIS:
            return self.ctx.gather(x, todo)
        issued = self._issued.pop((i, key), None)
        if issued is None:
            issued = self._regather(x, todo[0][1])
        buf, box = issued
        whole = _GatherWait.apply(buf, box).movedim(0, todo[0][1])
        return self.ctx.gather(whole, todo[1:])

    def _regather(self, x, dim):
        """A checkpointed layer's recompute: gather again, now, and hand
        back what a prefetch would have. The recompute must run the ops
        the checkpointed forward ran, which saw only the wait (the
        prefetch was issued outside the layer), so the gather runs
        outside the checkpoint's dispatch modes. It is differentiable, as
        the prefetch is, so that the recompute saves what the forward
        saved; the forward's graph carries the gradient."""
        from torch.utils._python_dispatch import _disable_current_modes

        box: list = []
        with _disable_current_modes():
            buf = _GatherStart.apply(x, dim, self.group, self.mode, box)
        return buf, box


def layer_gather_fn(ctx, gathers: dict) -> Optional[LayerGather]:
    """The overlapped gathers of a layer loop over ``ctx``'s mesh (a
    ``ShardContext``; None without a DeviceMesh), or None when overlap
    does not apply: mode off, no mesh, or an fsdp axis of 1."""
    mode = overlap_mode()
    if mode == "off" or ctx is None or ctx._size(_GATHER_AXIS) <= 1:
        return None
    return LayerGather(ctx, gathers, mode)


def plain_gather(ctx, gathers: dict):
    """``gather(key, local) -> whole`` with the plain (synchronous)
    gathers, for a loop that does not overlap."""
    return lambda key, x: ctx.gather(x, gathers[key])

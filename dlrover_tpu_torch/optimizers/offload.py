"""Host-offload Adam: the optimizer state lives in host memory, not on
the card (port of dlrover_tpu/optimizers/offload.py).

The device holds the params and the transient grads only; the two f32
moments of every param live in host memory (page-locked when the params
are on a GPU, so the copies run asynchronously). A step:

1. enqueues every grad's device-to-host copy into its host buffer, and
   records an event after each;
2. leaf by leaf, waits for that leaf's copy, runs the Adam math on the
   host with torch CPU ops (the moments updated in place), writes the
   update ``-lr * adam`` into the grad's host buffer and enqueues its
   host-to-device copy, so the copies of one leaf overlap the host math
   of the next;
3. on the device, ``p = p * (1 - lr * weight_decay) + update``
   (decoupled decay applied there: no copy of the params to the host).

All copies run on the current stream in order, so a step's copy into a
leaf's host buffer never overtakes the previous step's copy out of it.
This trades device memory (two f32 moments per param, 8 bytes a param)
for PCIe traffic (each grad down, each update up) and host compute.

On a DeviceMesh each rank keeps the host moments of its local shards
only, and copies, computes and updates local shards
(``parallel/mesh_state.py`` ``local``): the JAX package's update, which
is elementwise, on this rank's elements. ``state_dict()`` then gives
each moment as a DTensor placed as its param over the host shard, so a
sharded checkpoint and the in-process reshape move it as they move the
params.
"""

from __future__ import annotations

import time

import torch
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.mesh_state import local

logger = get_logger(__name__)


class OffloadAdam(torch.optim.Optimizer):
    """AdamW with host-resident moments: the JAX ``OffloadAdam``'s update,
    ``p * (1 - lr*wd) - lr * (mu/bc1) / (sqrt(nu/bc2) + eps)``, the bias
    corrections computed in double and rounded to f32 where they are used,
    as its host code does.
    A param without a grad counts as a zero grad.

    State: ``state["count"]`` and, per param, ``mu``/``nu`` (f32, on the
    host). ``state_dict()`` copies them (the step updates them in place,
    so a held reference would not be a snapshot); ``load_state_dict``
    copies back into the host buffers: the state never visits the
    device."""

    steps_on_mesh = True

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.state["count"] = 0
        self._host_grads = {}
        host_bytes = 0
        for p in self._params():
            lp = local(p)

            def buf():
                return torch.empty(lp.shape, dtype=torch.float32,
                                   pin_memory=lp.is_cuda).zero_()

            self.state[p] = {"mu": buf(), "nu": buf()}
            self._host_grads[p] = buf()
            host_bytes += 2 * lp.numel() * 4
        # one scratch buffer for the host math's temporaries, as large as
        # the largest param: fresh host allocations every step would
        # fault their pages in again each time
        self._scratch = torch.empty(max(
            (local(p).numel() for p in self._params()), default=0))
        logger.info("OffloadAdam: %.2f GB optimizer state on host",
                    host_bytes / (1 << 30))
        # the legs of the last step, for measurement: seconds waiting for
        # the device-to-host copies and in the host math
        self.last_legs: dict = {}

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        t = self.state["count"] + 1
        todo = []
        for group in self.param_groups:
            for p in group["params"]:
                host = self._host_grads[p]
                if p.grad is None:
                    host.zero_()
                    done = None
                else:
                    host.copy_(local(p.grad), non_blocking=True)
                    done = torch.cuda.Event() if p.is_cuda else None
                    if done is not None:
                        done.record()
                todo.append((group, p, host, done))
        wait_s = math_s = 0.0
        for group, p, host, done in todo:
            b1, b2 = group["b1"], group["b2"]
            lr, wd = group["lr"], group["weight_decay"]
            bc1 = 1.0 - b1 ** t
            bc2 = 1.0 - b2 ** t
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            t1 = time.perf_counter()
            st, lp = self.state[p], local(p)
            mu, nu = st["mu"], st["nu"]
            tmp = self._scratch[:lp.numel()].view(lp.shape)
            # the JAX host code's operations in its order, in place:
            # mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g**2;
            # -lr * (mu/bc1) / (sqrt(nu/bc2) + eps)
            torch.mul(host, 1.0 - b1, out=tmp)
            mu.mul_(b1).add_(tmp)
            torch.square(host, out=tmp)
            tmp.mul_(1.0 - b2)
            nu.mul_(b2).add_(tmp)
            torch.div(nu, bc2, out=tmp)
            tmp.sqrt_().add_(group["eps"])
            # the update takes the grad's place in its host buffer
            torch.div(mu, bc1, out=host)
            host.div_(tmp).mul_(-lr)
            math_s += time.perf_counter() - t1
            wait_s += t1 - t0
            upd = host.to(lp.device, dtype=lp.dtype, non_blocking=True)
            if wd:
                lp.mul_(1.0 - lr * wd)
            lp.add_(upd)
        self.state["count"] = t
        self.last_legs = {"d2h_wait_s": wait_s, "host_math_s": math_s}
        return loss

    # ------------------------------------------------------- checkpoints

    def state_dict(self):
        sd = super().state_dict()
        params = self._params()
        sd["state"] = {k: ({n: _like_param(params[k], v.clone())
                            for n, v in s.items()}
                           if isinstance(s, dict) else s)
                       for k, s in sd["state"].items()}
        return sd

    def load_state_dict(self, state_dict):
        bufs = {p: self.state[p] for p in self._params()}
        saved = state_dict["state"]
        super().load_state_dict({
            "state": {k: v for k, v in saved.items()
                      if not isinstance(k, int)},
            "param_groups": state_dict["param_groups"]})
        for i, p in enumerate(self._params()):
            for key, buf in bufs[p].items():
                buf.copy_(local(saved[i][key]))
            self.state[p] = bufs[p]


def _like_param(p, host):
    """A host moment of ``p``'s local shard as ``p`` is laid out: a
    DTensor placed as ``p`` over the host tensor when ``p`` is one."""
    if not isinstance(p, DTensor):
        return host
    return DTensor.from_local(host, p.device_mesh, list(p.placements),
                              run_check=False, shape=p.shape,
                              stride=p.stride())

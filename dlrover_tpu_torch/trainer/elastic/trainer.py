"""ElasticTrainer: a fixed global batch under a changing world size (port
of dlrover_tpu/trainer/elastic/trainer.py).

When the number of workers changes across a restart, the accumulation
steps change so that ``micro_batch x accum x world == global_batch``
stays constant. :meth:`wrap_step` wraps a gradient function and an
optimizer update into one step that splits the local batch into
``accum`` microbatches, sums their gradients, divides by ``accum`` and
applies once: the JAX package's ``lax.scan`` fold, as a loop.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class ElasticTrainer:
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 world_size: int = 1):
        self.global_batch_size = int(global_batch_size)
        self.micro_batch_size = int(micro_batch_size)
        self.set_world_size(world_size)

    def set_world_size(self, world_size: int):
        """Recompute accumulation for a new world size (post-restart)."""
        self.world_size = max(1, int(world_size))
        denom = self.micro_batch_size * self.world_size
        if self.global_batch_size % denom != 0:
            logger.warning(
                "global batch %d not divisible by micro %d x world %d; "
                "rounding accumulation up",
                self.global_batch_size, self.micro_batch_size,
                self.world_size,
            )
        self.accum_steps = max(1, -(-self.global_batch_size // denom))

    @property
    def local_batch_size(self) -> int:
        """Per-process batch the dataloader should produce each step."""
        return self.micro_batch_size * self.accum_steps

    # ------------------------------------------------------------- stepping

    def wrap_step(self, grad_fn, apply_fn):
        """Build an accumulating train step.

        ``grad_fn(params, microbatch) -> (loss, grads)`` (a loss and its
        gradients, e.g. through ``torch.func.grad_and_value`` or a
        backward). ``apply_fn(params, opt_state, grads) -> (params,
        opt_state)``: the optimizer update.

        Returns ``step(params, opt_state, batch) -> (params, opt_state,
        loss)`` where ``batch`` leaves have leading dim ``accum *
        micro_batch_size``; ``loss`` is the mean of the microbatches'
        losses. ``accum_steps`` is read at each call, so a
        :meth:`set_world_size` takes effect at the next step.
        """

        def step(params, opt_state, batch):
            accum = self.accum_steps
            micro = self.micro_batch_size
            micro_batches = pytree.tree_map(
                lambda x: x.reshape((accum, micro) + tuple(x.shape[1:])),
                batch)
            grads_sum, loss_sum = None, 0.0
            for i in range(accum):
                mb = pytree.tree_map(lambda x: x[i], micro_batches)
                loss, grads = grad_fn(params, mb)
                grads_sum = grads if grads_sum is None else pytree.tree_map(
                    lambda a, g: a + g, grads_sum, grads)
                loss_sum = loss_sum + loss
            grads = pytree.tree_map(lambda g: g / accum, grads_sum)
            params, opt_state = apply_fn(params, opt_state, grads)
            return params, opt_state, loss_sum / accum

        return step

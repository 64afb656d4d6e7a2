"""8-bit Adam: moments stored as block-quantized 8-bit codes (port of
dlrover_tpu/optimizers/low_bit.py).

Per leaf and step, as the JAX chain ``scale_by_adam8bit ->
add_decayed_weights -> scale_by_learning_rate`` does:

- mu is dequantized by K6 (``dequantize_int8``) and nu decoded through
  the log codebook (``dequantize_pos_log``, plain torch);
- the EMA, bias correction and update run in torch, and the param is
  updated in place, ``p += -lr * (adam + weight_decay * p)``;
- mu is requantized by K5 (``quantize_int8``, stochastic rounding) and
  nu by ``quantize_pos_log``.

So a step launches K5 and K6 once per leaf. ``adam8bit(fused=True)`` is
the one-launch alternative (``ops/fused_optim.py``, K8).

Leaf ``i`` is the optimizer's i-th param; ``auto_accelerate`` passes the
params in the JAX flattening order (``fused_optim.tree_order``), so the
rounding seed ``count * 7919 + i`` names the same leaf as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from dlrover_tpu_torch.ops.fused_optim import (
    Schedule,
    _clip,
    _global_norm,
    _scalars,
    fused_adamw,
)
from dlrover_tpu_torch.ops.quantization import (
    BLOCK,
    _n_rows,
    dequantize_int8,
    dequantize_pos_log,
    quantize_int8,
    quantize_pos_log,
)


class Adam8bit(torch.optim.Optimizer):
    """AdamW over 8-bit moments, leaf by leaf.

    mu is int8 linear absmax per 256-block with stochastic rounding; nu
    is uint8 on the log codebook; each with an f32 scale per block. The
    rounding field of leaf ``i`` at step ``count`` (post-increment) is
    ``uniform(count, i, shape)`` when given, else ``torch.rand`` from a
    generator seeded with ``count * 7919 + i`` (JAX's seed; the bits
    differ). A param without a grad counts as a zero grad.

    State: ``state["count"]`` and, per param, ``mu_q``/``mu_scale``/
    ``nu_q``/``nu_scale`` ([rows, BLOCK] codes, [rows, 1] scales).
    """

    def __init__(self, params, lr: Union[float, Schedule] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: Optional[float] = None,
                 uniform: Optional[Callable] = None):
        super().__init__(params, dict(lr=lr))
        if len(self.param_groups) != 1:
            raise ValueError("Adam8bit takes one param group: its "
                             "hyperparameters hold for the whole tree")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.uniform = uniform
        self.state["count"] = 0
        # zeros quantize trivially: build the codes directly
        for p in self.param_groups[0]["params"]:
            rows = _n_rows(p.numel())
            self.state[p] = {
                "mu_q": torch.zeros((rows, BLOCK), dtype=torch.int8,
                                    device=p.device),
                "mu_scale": torch.ones((rows, 1), device=p.device),
                "nu_q": torch.zeros((rows, BLOCK), dtype=torch.uint8,
                                    device=p.device),
                "nu_scale": torch.ones((rows, 1), device=p.device),
            }
        self._generators: dict = {}

    def load_state_dict(self, state_dict):
        """torch casts each param's state tensors to the param's dtype on
        load, which would leave the codes in f32: put them back in their
        8-bit dtypes (their values are integers, so the round trip is
        exact)."""
        super().load_state_dict(state_dict)
        for p in self.param_groups[0]["params"]:
            st = self.state[p]
            st["mu_q"] = st["mu_q"].to(torch.int8)
            st["nu_q"] = st["nu_q"].to(torch.uint8)

    def _draw_uniform(self, count: int, index: int, rows: int, device):
        shape = (rows, BLOCK)
        if self.uniform is not None:
            return torch.as_tensor(self.uniform(count, index, shape),
                                   dtype=torch.float32).to(device)
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
        gen.manual_seed(count * 7919 + index)
        return torch.rand(shape, generator=gen, device=device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.param_groups[0]["params"]
        count = self.state["count"]
        count_inc = count + 1
        b1, b2 = self.b1, self.b2
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        g_norm = (_global_norm(grads) if self.clip_norm is not None
                  else None)
        sc = _scalars(count, count_inc, self.param_groups[0]["lr"], b1, b2,
                      g_norm, params[0].device)
        for i, (p, g) in enumerate(zip(params, grads)):
            st = self.state[p]
            g = _clip(g.float(), sc, self.clip_norm)
            mu = dequantize_int8(st["mu_q"], st["mu_scale"], p.shape)
            nu = dequantize_pos_log(st["nu_q"], st["nu_scale"], p.shape)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            upd = (mu / sc[1]) / (torch.sqrt(nu / sc[2]) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.add_(upd * sc[0])
            u = self._draw_uniform(count_inc, i, st["mu_q"].shape[0],
                                   p.device)
            st["mu_q"], st["mu_scale"], _ = quantize_int8(mu, u=u)
            st["nu_q"], st["nu_scale"] = quantize_pos_log(nu)
        self.state["count"] = count_inc
        return loss


def adam8bit(
    learning_rate: Union[float, Schedule] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    fused: bool = False,
    clip_norm: Optional[float] = None,
) -> Callable:
    """``params -> optimizer``: 8-bit AdamW (decoupled weight decay over
    quantized moments).

    ``fused=True`` (the ``Strategy.fused_optim`` lever) gives the
    one-launch variant, ``fused_adamw(bits=8)``: the same state format,
    one kernel over every leaf; it differs from the per-leaf chain by its
    rounding draws and its analytic (not tabulated) nu decode.
    ``clip_norm`` clips by the global grad norm first."""
    if fused:
        return fused_adamw(learning_rate, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, clip_norm=clip_norm,
                           bits=8)
    return lambda params: Adam8bit(
        params, lr=learning_rate, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, clip_norm=clip_norm)

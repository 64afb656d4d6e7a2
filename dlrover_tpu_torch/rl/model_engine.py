"""ModelEngine: actor/critic/ref/reward models of an RLHF loop (port of
dlrover_tpu/rl/model_engine.py).

Each role is (init_fn, apply_fn, trainable, optimizer). ``init_fn`` takes
a seed and returns the port's params (a flat dict of tensors), which the
engine places on its device; a trainable role's float params require
grad and ``optimizer`` is a factory from that dict to a
``torch.optim.Optimizer``. :meth:`ModelEngine.apply` runs a forward under
``torch.no_grad()`` ("inference mode" is a forward without gradient).

The JAX package also gives each role its own ``Strategy``, a mesh with
sharded params and optimizer state, and re-lays a role's params onto
another mesh (:meth:`reshard`, the DS hybrid engine's train -> inference
reshape). The port does not run those yet: a spec with a strategy and
:meth:`reshard` raise, naming the ROADMAP item (Queue 1, item 11's
sharded RL roles). Without strategies every role has the same layout,
so :meth:`sync_ref_from_actor` is a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.device import resolve_device

logger = get_logger(__name__)

SHARDED_ROLES = (
    "RL roles under a Strategy (a mesh per role, sharded params and "
    "optimizer state, the hybrid engine's reshard) are not ported yet "
    "(ROADMAP Queue 1 item 11: sharded RL roles)")


@dataclasses.dataclass
class ModelSpec:
    """One RLHF role (actor | critic | ref | reward)."""

    init_fn: Callable                 # seed -> params (flat dict)
    apply_fn: Callable                # (params, *inputs) -> outputs
    logical_axes: Any = None          # axis names per param (or None)
    strategy: Optional[Any] = None    # a parallel.Strategy: raises
    trainable: bool = False
    optimizer: Any = None             # params -> torch.optim.Optimizer


class ModelEngine:
    """Holds the role -> model mapping, their params and optimizers. Runs
    on ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, specs: dict, seed: int = 0, device=None):
        self.specs = dict(specs)
        self.device = resolve_device(device)
        self.params: dict = {}
        self.optimizers: dict = {}
        rng = torch.Generator().manual_seed(int(seed))
        for name, spec in self.specs.items():
            sub = int(torch.randint(0, 2 ** 62, (), generator=rng))
            if spec.trainable and spec.optimizer is None:
                raise ValueError(
                    f"trainable model {name!r} needs an optimizer")
            if spec.strategy is not None:
                raise NotImplementedError(f"{name}: {SHARDED_ROLES}")
            params = {k: v.to(self.device)
                      for k, v in spec.init_fn(sub).items()}
            if spec.trainable:
                params = {k: v.detach().requires_grad_(v.is_floating_point())
                          for k, v in params.items()}
                self.optimizers[name] = spec.optimizer(params)
            self.params[name] = params
            logger.info("model engine: %s (%strainable, no strategy)",
                        name, "" if spec.trainable else "not ")

    # ------------------------------------------------------------- access

    def apply(self, name: str, *inputs):
        """Run a model forward without gradient."""
        with torch.no_grad():
            return self.specs[name].apply_fn(self.params[name], *inputs)

    def optimizer(self, name: str):
        return self.optimizers[name]

    @property
    def opt_states(self) -> dict:
        return {name: opt.state_dict()
                for name, opt in self.optimizers.items()}

    @property
    def actor(self):
        return self.params.get("actor")

    @property
    def critic(self):
        return self.params.get("critic")

    @property
    def ref(self):
        return self.params.get("ref")

    @property
    def reward(self):
        return self.params.get("reward")

    def sync_ref_from_actor(self):
        """Refresh the frozen reference from the actor (periodic KL
        anchor refresh): a copy of the actor's current values, which the
        actor's later optimizer steps leave untouched (the JAX package
        aliases its immutable arrays)."""
        if "ref" not in self.params or "actor" not in self.params:
            return
        self.params["ref"] = {k: v.detach().clone()
                              for k, v in self.params["actor"].items()}

    def reshard(self, name: str, target_strategy, logical_axes=None,
                devices=None):
        """The hybrid engine's re-lay of a role's params onto another
        mesh: not ported yet."""
        raise NotImplementedError(f"reshard({name!r}): {SHARDED_ROLES}")

    # -------------------------------------------------------- persistence

    def state_dict(self) -> dict:
        return {"params": self.params, "opt_states": self.opt_states}

    def load_state_dict(self, state: dict):
        for name, params in state.get("params", {}).items():
            with torch.no_grad():
                for k, v in params.items():
                    self.params[name][k].copy_(v)
        for name, opt_state in state.get("opt_states", {}).items():
            self.optimizers[name].load_state_dict(opt_state)

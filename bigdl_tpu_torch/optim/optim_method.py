"""Optimization methods, ported from ``bigdl_tpu/optim/optim_method.py``
(so far: the base, the ``Default`` schedule and ``SGD``).

The JAX package's functional core ``update(grads, params, state) ->
(new_params, new_state)`` becomes an in-place update of the f32 master
parameters under ``torch.no_grad()`` that returns the new state: the
parameters are not copied, which saves one model's worth of memory.
The state keeps the same keys (``neval``, ``epoch``, ``velocity``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["OptimMethod", "LearningRateSchedule", "Default", "SGD"]

Tensors = Dict[str, torch.Tensor]


class LearningRateSchedule:
    """Maps (base_lr, state) -> lr."""

    def rate(self, base_lr: float, state: Dict[str, Any]) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Torch default: lr / (1 + neval * lrd) (``SGD.scala`` Default)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.learning_rate_decay = learning_rate_decay

    def rate(self, base_lr, state):
        return base_lr / (1.0 + state["neval"] * self.learning_rate_decay)


class OptimMethod:
    """Base (``optim/OptimMethod.scala:38``)."""

    def init_state(self, params: Tensors) -> Dict[str, Any]:
        return {"neval": 0, "epoch": 1}

    def update(self, grads: Tensors, params: Tensors,
               state: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one step to ``params`` in place; return the new state."""
        raise NotImplementedError


class SGD(OptimMethod):
    """SGD with momentum, dampening, Nesterov and weight decay and the
    ``Default`` schedule (``optim/SGD.scala``)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = 0.0 if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and "
                             "dampening = 0")
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def init_state(self, params):
        st = super().init_state(params)
        if self.momentum > 0:
            st["velocity"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        lr = self.schedule.rate(self.learning_rate, state)
        new_state = dict(state)
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay != 0:
                g = g + self.weight_decay * p
            if self.momentum > 0:
                v = state["velocity"][k]
                if state["neval"] == 0:
                    # the first step COPIES the raw gradient into the
                    # buffer; dampening applies from step 2 on
                    # (``SGD.scala:95``, VERDICT row 31)
                    v.copy_(g)
                else:
                    v.mul_(self.momentum).add_((1.0 - self.dampening) * g)
                step = g + self.momentum * v if self.nesterov else v
            else:
                step = g
            p.sub_(lr * step)
        new_state["neval"] = state["neval"] + 1
        return new_state

"""Regularizers, ported from ``bigdl_tpu/optim/regularizer.py``
(``optim/Regularizer.scala``: L1L2Regularizer, L1Regularizer,
L2Regularizer).

A layer names its regularizers (``w_regularizer``, ``b_regularizer``);
the train step adds each enabled regularizer's :meth:`~Regularizer.loss`
of the f32 master parameter to the loss it differentiates, unless the
layer is frozen.
"""

from __future__ import annotations

import torch

__all__ = ["Regularizer", "L1L2Regularizer", "L1Regularizer",
           "L2Regularizer"]


class Regularizer:
    def __init__(self):
        self.is_enabled = True

    def enable(self):
        self.is_enabled = True
        return self

    def disable(self):
        self.is_enabled = False
        return self

    def grad(self, param: torch.Tensor):
        """Gradient contribution d(penalty)/d(param)."""
        raise NotImplementedError

    def loss(self, param: torch.Tensor):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """``l1 * sum|p| + l2 / 2 * sum p^2``."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        super().__init__()
        self.l1, self.l2 = l1, l2

    def grad(self, param):
        g = 0.0
        if self.l1 != 0:
            g = g + self.l1 * torch.sign(param)
        if self.l2 != 0:
            g = g + self.l2 * param
        return g

    def loss(self, param):
        total = 0.0
        if self.l1 != 0:
            total = total + self.l1 * torch.sum(torch.abs(param))
        if self.l2 != 0:
            total = total + 0.5 * self.l2 * torch.sum(param * param)
        return total


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l1=0.0, l2=l2)

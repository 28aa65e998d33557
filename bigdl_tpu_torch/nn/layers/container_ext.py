"""Concat, ConcatTable and TimeDistributed, ported from
``bigdl_tpu/nn/layers/container_ext.py``."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container, Module

__all__ = ["Concat", "ConcatTable", "TimeDistributed"]


class Concat(Container):
    """Apply every member to the same input and concatenate the outputs
    along the 0-based axis ``dim`` (``nn/Concat.scala``)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()], dim=self.dim)


class ConcatTable(Container):
    """Apply every member to the same input and return the outputs as a
    list, a table (``nn/ConcatTable.scala``)."""

    def forward(self, x):
        return [m(x) for m in self._modules.values()]


class TimeDistributed(Container):
    """Apply the inner module to every step of [batch, time, ...] input
    (``nn/TimeDistributed.scala``) by folding time into the batch; the
    inner module is child ``"0"``."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        out = self.get(0)(x.reshape((b * t,) + tuple(x.shape[2:])))
        return out.reshape((b, t) + tuple(out.shape[1:]))

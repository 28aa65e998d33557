"""Concat, ported from ``bigdl_tpu/nn/layers/container_ext.py``."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container

__all__ = ["Concat"]


class Concat(Container):
    """Apply every member to the same input and concatenate the outputs
    along the 0-based axis ``dim`` (``nn/Concat.scala``)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()], dim=self.dim)

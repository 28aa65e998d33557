"""View and CAddTable, ported from ``bigdl_tpu/nn/layers/shape.py``."""

from __future__ import annotations

import math

from bigdl_tpu_torch.nn.module import Module

__all__ = ["View", "CAddTable"]


class View(Module):
    """(``nn/View.scala``): reshape allowing one -1."""

    def __init__(self, *sizes: int):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int):
        self.num_input_dims = n
        return self

    def forward(self, x):
        if self.num_input_dims and x.ndim > self.num_input_dims:
            # batch-shift: keep the leading (ndim - num_input_dims) dims
            lead = tuple(x.shape[: x.ndim - self.num_input_dims])
            return x.reshape(lead + self.sizes)
        n_elem = math.prod(s for s in self.sizes if s != -1)
        if -1 not in self.sizes and x.numel() != n_elem:
            return x.reshape((-1,) + self.sizes)  # leading batch dim kept
        return x.reshape(self.sizes)


class CAddTable(Module):
    """The elementwise sum of a table's tensors (``nn/CAddTable.scala``).
    ``inplace`` is accepted for the reference's signature; as in the JAX
    package the sum is a new tensor, so autograd may keep the inputs."""

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace

    def forward(self, xs):
        out = xs[0]
        for t in xs[1:]:
            out = out + t
        return out

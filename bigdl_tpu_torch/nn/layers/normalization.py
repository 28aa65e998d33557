"""Cross-map LRN and dropout, ported from
``bigdl_tpu/nn/layers/normalization.py``."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.lrn import cross_map_lrn

__all__ = ["SpatialCrossMapLRN", "Dropout", "dropout_generator"]

#: the generator training-mode dropout draws its masks from
_generator: Optional[torch.Generator] = None


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]
                      ) -> Iterator[None]:
    """Draw every dropout mask inside the block from ``generator`` (on
    the activations' device); the train step owns it, as the JAX step
    owns the ``rng`` key it hands the layers."""
    global _generator
    saved, _generator = _generator, generator
    try:
        yield
    finally:
        _generator = saved


class SpatialCrossMapLRN(Module):
    """AlexNet-style local response normalization across the channels of
    NCHW input (``nn/SpatialCrossMapLRN.scala``)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        # the reference only defines odd windows (SpatialCrossMapLRN.scala:59)
        if size % 2 != 1:
            raise ValueError(f"LRN only supports odd size, got {size}")
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if x.ndim == 4:
            out = cross_map_lrn(x, self.size, self.alpha, self.beta, self.k)
            return out[0] if squeeze else out
        # rank > 4: generic channel-window version on every device, as in
        # the JAX package (normalization.py:200-210), which has no kernel
        half = (self.size - 1) // 2
        sq = (x * x).movedim(1, -1)
        sq = F.pad(sq, (half, self.size - 1 - half))
        window_sum = sq.unfold(-1, self.size, 1).sum(-1).movedim(-1, 1)
        scale = self.k + window_sum * (self.alpha / self.size)
        out = x * torch.pow(scale, -self.beta)
        return out[0] if squeeze else out


class Dropout(Module):
    """Inverted dropout (``nn/Dropout.scala``): the identity in eval
    mode; in training it keeps each value with probability ``1 - p``
    and, with ``scale``, divides the kept values by ``1 - p``.  The mask
    comes from the generator of :func:`dropout_generator` (PyTorch's
    default generator outside one)."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        u = torch.rand(x.shape, generator=_generator, device=x.device)
        out = torch.where(u < 1.0 - self.p, x, 0.0)
        if self.scale:
            out = out / (1.0 - self.p)
        return out

"""Cross-map LRN and dropout, ported from
``bigdl_tpu/nn/layers/normalization.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.lrn import cross_map_lrn_forward

__all__ = ["SpatialCrossMapLRN", "Dropout"]


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
            out = cross_map_lrn_forward(x, self.size, self.alpha, self.beta,
                                        self.k)
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
    mode; in training it zeroes with probability ``p`` and divides the
    kept values by ``1 - p``."""

    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = init_p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)

"""Activations, ported from ``bigdl_tpu/nn/layers/activation.py``."""

from __future__ import annotations

import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module

__all__ = ["ReLU", "LogSoftMax"]


class ReLU(Module):
    """max(x, 0).  ``ip`` (in place) is accepted for the reference's
    signature; the port never writes its input."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class LogSoftMax(Module):
    """(``nn/LogSoftMax.scala``) over the feature axis: 1 for batched
    input, else 0."""

    def forward(self, x):
        return F.log_softmax(x, dim=1 if x.ndim >= 2 else 0)

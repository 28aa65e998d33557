"""Linear, ported from ``bigdl_tpu/nn/layers/linear.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init import RandomUniform
from bigdl_tpu_torch.nn.module import Module

__all__ = ["Linear"]


class Linear(Module):
    """y = x W^T + b (``nn/Linear.scala``); weight layout (out, in); no
    ``bias`` parameter without ``with_bias``."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        init = RandomUniform()
        self.weight = torch.nn.Parameter(init.init(
            (output_size, input_size), input_size, generator))
        if with_bias:
            self.bias = torch.nn.Parameter(init.init(
                (output_size,), input_size, generator))

    def forward(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        # the weight follows the activation dtype (linear.py:67)
        bias = self.bias.to(x.dtype) if self.with_bias else None
        y = F.linear(x, self.weight.to(x.dtype), bias)
        return y[0] if squeeze else y

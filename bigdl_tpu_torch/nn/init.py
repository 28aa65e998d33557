"""Initialization, ported from ``bigdl_tpu/nn/init.py`` (the rules the
convolution, linear and embedding layers use).

Draws come from an explicit ``torch.Generator`` (the caller's, else
PyTorch's default generator), made on the CPU; layers move to their
device afterwards.  The JAX package draws from numpy's global RNG, so
the two packages give different weights from the same seed: parity
tests copy weights across by key instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["RandomUniform", "RandomNormal"]


class RandomUniform:
    """The Torch default U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""

    def init(self, shape, fan_in: int,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bound = 1.0 / math.sqrt(fan_in)
        return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            -bound, bound, generator=generator)


class RandomNormal:
    """N(mean, stdv), the embedding tables' rule."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, shape, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=torch.float32).normal_(
            self.mean, self.stdv, generator=generator)

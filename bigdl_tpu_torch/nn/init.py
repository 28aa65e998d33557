"""Initialization methods, ported from ``bigdl_tpu/nn/init.py``
(``nn/InitializationMethod.scala``: Zeros, Ones, ConstInitMethod,
RandomUniform, RandomNormal, Xavier, MsraFiller, BilinearFiller).

Random draws come from an explicit ``torch.Generator`` (the caller's,
else PyTorch's default generator), made on the CPU in f32; layers move
to their device afterwards.  The JAX package draws from numpy's global
RNG, so the two packages give different weights from the same seed:
parity tests copy weights across by key instead.  The deterministic
methods (zeros, ones, constants, the bilinear kernel) give the same
values in both.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "BilinearFiller"]


def _fans(shape, fan_in, fan_out):
    """(fan_in, fan_out), defaulting to prod(shape[1:]) and shape[0]."""
    fi = fan_in if fan_in else (math.prod(shape[1:]) or 1)
    fo = fan_out if fan_out else int(shape[0])
    return fi, fo


class InitializationMethod:
    def init(self, shape, fan_in: Optional[int] = None,
             fan_out: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


class _Zeros(InitializationMethod):
    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.zeros(tuple(shape), dtype=torch.float32)


class _Ones(InitializationMethod):
    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.ones(tuple(shape), dtype=torch.float32)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32)


class RandomUniform(InitializationMethod):
    """U(lower, upper); with no bounds, the Torch default
    U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower, self.upper = lower, upper

    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        if self.lower is None:
            bound = 1.0 / math.sqrt(_fans(shape, fan_in, fan_out)[0])
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    """N(mean, stdv), the embedding tables' rule."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.empty(tuple(shape), dtype=torch.float32).normal_(
            self.mean, self.stdv, generator=generator)


class _Xavier(InitializationMethod):
    """Glorot uniform: U(-sqrt(6/(fan_in+fan_out)), +)."""

    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        fi, fo = _fans(shape, fan_in, fan_out)
        bound = math.sqrt(6.0 / (fi + fo))
        return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            -bound, bound, generator=generator)


class MsraFiller(InitializationMethod):
    """He/MSRA normal init: N(0, sqrt(2/n)), n the fan in, or the mean of
    both fans with ``variance_norm_average``."""

    def __init__(self, variance_norm_average: bool = False):
        self.variance_norm_average = variance_norm_average

    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        fi, fo = _fans(shape, fan_in, fan_out)
        n = (fi + fo) / 2.0 if self.variance_norm_average else fi
        return torch.empty(tuple(shape), dtype=torch.float32).normal_(
            0.0, math.sqrt(2.0 / n), generator=generator)


class BilinearFiller(InitializationMethod):
    """The bilinear upsampling kernel over the trailing (kH, kW) axes,
    for full (transposed) convolutions; the same in every leading
    slice."""

    def init(self, shape, fan_in=None, fan_out=None, generator=None):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = np.ceil(kh / 2.0), np.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        y = np.arange(kh).reshape(-1, 1)
        x = np.arange(kw).reshape(1, -1)
        kernel = (1 - np.abs(y / f_h - c_h)) * (1 - np.abs(x / f_w - c_w))
        out = np.zeros(tuple(shape), dtype=np.float32)
        out[...] = kernel
        return torch.from_numpy(out)


Zeros = _Zeros()
Ones = _Ones()
Xavier = _Xavier()

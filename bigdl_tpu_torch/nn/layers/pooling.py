"""Spatial pooling, ported from ``bigdl_tpu/nn/layers/pooling.py``.

Torch ceil-mode semantics come from explicit asymmetric padding
(``_axis_padding``, copied from the JAX package): ``hi`` includes the
ceil overflow, and the last window must start inside the input plus the
left pad.  Average pooling goes through ``ops/pool.py``, whose divisor
counts declared padding under ``count_include_pad`` and never counts the
ceil overflow.

Max pooling follows the JAX ``_PoolBase._max`` branch for branch:

- ``split_ties()`` with at most 64 taps and a float dtype: the
  equal-tie-split gradient (``ops/pool.py`` ``maxpool_tie_split``, CUDA
  kernels for 4-D input);
- otherwise, with ``argmax_index`` on and the input one the JAX argmax
  path takes (``ops/pooling.py`` ``pool_kernel_supported``: 4-D bf16 or
  f16): the first-maximum gradient from a saved int8 tap index
  (``maxpool_argmax``, CUDA kernels);
- otherwise, the default: pad with -inf and run ``F.max_pool2d`` with no
  padding of its own, which is the JAX package's ``reduce_window`` and
  launches no kernel of the port; its autograd sends each window's
  gradient to the first maximum in window order, as XLA's
  select-and-scatter does, and the padding never wins a window.

``argmax_index`` is the port's form of the JAX environment switch
``BIGDL_POOL_KERNEL`` (``on``), set per layer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.pool import avg_pool, maxpool_tie_split, window_sum
from bigdl_tpu_torch.ops.pooling import maxpool_argmax, pool_kernel_supported

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling"]


def _pool_out_size(size: int, k: int, stride: int, pad: int,
                   ceil_mode: bool) -> int:
    if ceil_mode:
        out = int(math.ceil(float(size - k + 2 * pad) / stride)) + 1
    else:
        out = int(math.floor(float(size - k + 2 * pad) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1  # Torch: last window must start inside the (left-)padded input
    return out


def _axis_padding(size: int, k: int, stride: int, pad: int, ceil_mode: bool
                  ) -> Tuple[int, int, int]:
    """(lo, hi, declared_hi): hi includes ceil-overflow; declared_hi is the
    part of hi within the user-declared padding (counts toward the
    count_include_pad divisor)."""
    if pad == -1:  # SAME
        out = -(-size // stride)
        total = max(0, (out - 1) * stride + k - size)
        lo, hi = total // 2, total - total // 2
        return lo, hi, hi
    out = _pool_out_size(size, k, stride, pad, ceil_mode)
    needed = (out - 1) * stride + k
    hi = max(0, needed - size - pad)
    return pad, hi, min(hi, pad)


class SpatialMaxPooling(Module):
    """(``nn/SpatialMaxPooling.scala``) over the trailing (H, W) axes of
    3-D or 4-D NCHW input; pad == -1 means SAME (per axis).
    ``argmax_index`` turns on the argmax-index path for the inputs it
    takes (see the module docstring)."""

    #: largest window (taps per element) the tie-split path takes; larger
    #: windows run the default path, as in the JAX package
    _TIE_SPLIT_MAX_TAPS = 64

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False, *, argmax_index: bool = False):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False
        self.global_pooling = global_pooling
        self.tie_split = False
        self.argmax_index = argmax_index

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def torch_ties(self):
        """First-maximum tie gradient (the reference's semantics), the
        default."""
        self.tie_split = False
        return self

    def split_ties(self):
        """Equal-split tie gradient (conserves the gradient mass across
        tied maxima)."""
        self.tie_split = True
        return self

    def use_argmax_index(self, on: bool = True):
        """Set ``argmax_index`` (the first-maximum gradient from a saved
        int8 tap index, for 4-D bf16 or f16 input)."""
        self.argmax_index = on
        return self

    def _window(self, x):
        """(dims, strides, pads, declared) over every axis of ``x``."""
        if self.global_pooling:
            self.kh, self.kw = x.shape[-2], x.shape[-1]
            self.dh, self.dw = self.kh, self.kw
        nd = x.ndim
        dims, strides = [1] * nd, [1] * nd
        pads, declared = [(0, 0)] * nd, [(0, 0)] * nd
        for ax, k, d, p in ((nd - 2, self.kh, self.dh, self.pad_h),
                            (nd - 1, self.kw, self.dw, self.pad_w)):
            dims[ax], strides[ax] = k, d
            lo, hi, dhi = _axis_padding(x.shape[ax], k, d, p, self.ceil_mode)
            pads[ax] = (lo, hi)
            declared[ax] = (lo, dhi)
        return tuple(dims), tuple(strides), tuple(pads), tuple(declared)

    def forward(self, x):
        dims, strides, pads, _ = self._window(x)
        if self.tie_split and math.prod(dims) <= self._TIE_SPLIT_MAX_TAPS \
                and x.is_floating_point():
            return maxpool_tie_split(x, dims, strides, pads)
        if not self.tie_split and pool_kernel_supported(
                x, dims, strides, pads, self.argmax_index):
            return maxpool_argmax(x, dims, strides, pads)
        (lo_h, hi_h), (lo_w, hi_w) = pads[-2], pads[-1]
        xp = F.pad(x, (lo_w, hi_w, lo_h, hi_h), value=-math.inf)
        return F.max_pool2d(xp, dims[-2:], strides[-2:])


class SpatialAveragePooling(SpatialMaxPooling):
    """(``nn/SpatialAveragePooling.scala``); ``divide=False`` returns the
    plain window sum.  The tie and argmax settings it inherits have no
    effect on it, as in the JAX package."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False, ceil_mode: bool = False,
                 count_include_pad: bool = True, divide: bool = True):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, global_pooling)
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def forward(self, x):
        dims, strides, pads, declared = self._window(x)
        if not self.divide:
            return window_sum(x, dims, strides, pads)
        return avg_pool(x, dims, strides, pads, declared,
                        self.count_include_pad)

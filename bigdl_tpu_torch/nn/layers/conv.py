"""2-D convolution, ported from ``bigdl_tpu/nn/layers/conv.py``.

Torch weight layout (out, in/group, kH, kW), ``pad = -1`` meaning SAME,
``n_group`` for grouped convolution.  The JAX package leaves the conv
to XLA outside any Pallas kernel, so the port calls
``torch.nn.functional.conv2d``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init import RandomUniform
from bigdl_tpu_torch.nn.module import Module

__all__ = ["SpatialConvolution"]


def _pair_padding(pad: int, k: int, stride: int, size: int) -> Tuple[int, int]:
    """Explicit (lo, hi) padding; pad == -1 is SAME (TF convention)."""
    if pad == -1:
        out = -(-size // stride)
        total = max(0, (out - 1) * stride + k - size)
        return total // 2, total - total // 2
    return pad, pad


class SpatialConvolution(Module):
    """2-D convolution over NCHW (``nn/SpatialConvolution.scala``)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane}->{n_output_plane} "
                             f"not divisible by n_group {n_group}")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        fan_in = n_input_plane // n_group * kernel_h * kernel_w
        init = RandomUniform()
        self.weight = torch.nn.Parameter(init.init(
            (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            fan_in, generator))
        self.bias = torch.nn.Parameter(init.init(
            (n_output_plane,), fan_in, generator))

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        ph = _pair_padding(self.pad_h, self.kernel_h, self.stride_h, x.shape[2])
        pw = _pair_padding(self.pad_w, self.kernel_w, self.stride_w, x.shape[3])
        if ph[0] != ph[1] or pw[0] != pw[1]:  # asymmetric SAME
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            ph, pw = (0, 0), (0, 0)
        # the weight follows the activation dtype (conv.py:114): bf16
        # state with f32 input computes in f32 on bf16-rounded weights
        y = F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                     (self.stride_h, self.stride_w), (ph[0], pw[0]),
                     groups=self.n_group)
        return y[0] if squeeze else y

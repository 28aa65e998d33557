"""Batch normalization, cross-map and within-channel LRN, the
subtractive, divisive and contrastive normalizations, and dropout,
ported from ``bigdl_tpu/nn/layers/normalization.py``.

Batch normalization has no Pallas kernel in the JAX package: its
training mode is the fused custom VJP ``_bn_train_apply``, which this
port keeps as a ``torch.autograd.Function`` of plain PyTorch
(:class:`_BatchNormTrain`).  NCHW only; the NHWC layout is not ported
yet.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.lrn import cross_map_lrn, within_channel_lrn
from bigdl_tpu_torch.ops.norm import divisive_norm, subtractive_norm

__all__ = ["BatchNormalization", "SpatialBatchNormalization",
           "SpatialCrossMapLRN", "SpatialWithinChannelLRN",
           "SpatialSubtractiveNormalization", "SpatialDivisiveNormalization",
           "SpatialContrastiveNormalization", "Dropout", "dropout_generator"]

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


def _bn_shape(x: torch.Tensor, axis: int):
    """(reduced axes, per-feature broadcast shape, reduced count)."""
    axes = tuple(a for a in range(x.ndim) if a != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return axes, shape, x.numel() // max(x.shape[axis], 1)


class _BatchNormTrain(torch.autograd.Function):
    """Training batch norm with the JAX package's hand-written VJP
    (``_bn_train_fwd_impl`` / ``_bn_train_vjp_bwd``): one f32 sum and
    sum of squares forward, ``var = max(s2/n - mean^2, 0)`` (the biased
    variance normalizes), ``scale`` and ``shift`` rounded to the input's
    dtype and ``out = x * scale + shift``; backward, ``dbeta`` and
    ``dgamma`` summed in f32 and the fused ``dx`` formula.  Returns
    ``(out, mean, var)``, the statistics in f32 and without gradient
    (they only feed the running buffers)."""

    @staticmethod
    def forward(ctx, x, weight, bias, axis: int, eps: float):
        axes, shape, n = _bn_shape(x, axis)
        xf = x.float()
        s1 = torch.sum(x, dim=axes, dtype=torch.float32)
        s2 = torch.sum(xf * xf, dim=axes)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        scale = (inv * weight).reshape(shape).to(x.dtype)
        shift = (bias - mean * inv * weight).reshape(shape).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return x * scale + shift, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, inv = ctx.saved_tensors
        axes, shape, n = _bn_shape(x, ctx.axis)
        gy32 = gy.float()
        xhat32 = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = torch.sum(gy32, dim=axes)
        dgamma = torch.sum(gy32 * xhat32, dim=axes)
        k = (weight * inv).reshape(shape)
        dx = (k * (gy32 - (dbeta / n).reshape(shape)
                   - xhat32 * (dgamma / n).reshape(shape))).to(x.dtype)
        return dx, dgamma.to(weight.dtype), dbeta.to(weight.dtype), None, None


class BatchNormalization(Module):
    """Batch norm over [batch, feature] (``nn/BatchNormalization.scala``)
    and, through :class:`SpatialBatchNormalization`, over NCHW.

    Parameters ``weight`` and ``bias`` (with ``affine``) and f32 buffers
    ``running_mean`` and ``running_var``, under the JAX package's keys.
    Training mode normalizes with the batch statistics and moves the
    running buffers by ``momentum`` toward the mean and the unbiased
    variance, in f32 whatever the input's dtype; evaluation mode
    normalizes with the running buffers."""

    _feature_axis = 1

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None):
        super().__init__()
        self.n_output, self.eps = n_output, eps
        self.momentum, self.affine = momentum, affine
        if affine:
            self.weight = torch.nn.Parameter(
                torch.as_tensor(init_weight, dtype=torch.float32).clone()
                if init_weight is not None
                else torch.ones(n_output, dtype=torch.float32))
            self.bias = torch.nn.Parameter(
                torch.as_tensor(init_bias, dtype=torch.float32).clone()
                if init_bias is not None
                else torch.zeros(n_output, dtype=torch.float32))
        self.register_buffer("running_mean",
                             torch.zeros(n_output, dtype=torch.float32))
        self.register_buffer("running_var",
                             torch.ones(n_output, dtype=torch.float32))

    def forward(self, x):
        axis = self._feature_axis
        shape = [1] * x.ndim
        shape[axis] = self.n_output
        if self.training:
            ones = x.new_ones(self.n_output, dtype=torch.float32)
            w = self.weight if self.affine else ones
            b = self.bias if self.affine else torch.zeros_like(ones)
            out, mean, var = _BatchNormTrain.apply(x, w, b, axis, self.eps)
            n = x.numel() // self.n_output
            unbiased = var * n / max(n - 1, 1)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(
                    (1 - m) * self.running_mean + m * mean)
                self.running_var.copy_(
                    (1 - m) * self.running_var + m * unbiased)
            return out
        inv = torch.rsqrt(self.running_var + self.eps).reshape(shape)
        out = (x - self.running_mean.reshape(shape)) * inv
        if self.affine:
            out = out * self.weight.reshape(shape) \
                + self.bias.reshape(shape)
        return out.to(x.dtype)


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over [batch, C, H, W]
    (``nn/SpatialBatchNormalization.scala``), NCHW only."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None, format: str = "NCHW"):
        if format != "NCHW":
            raise NotImplementedError("the port's batch norm is NCHW only")
        super().__init__(n_output, eps, momentum, affine, init_weight,
                         init_bias)


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


def _gaussian_kernel(size: int) -> np.ndarray:
    """The normalizations' default smoothing kernel: a size x size
    Gaussian of sigma size / 4, summing to 1 (f32)."""
    sigma = 0.25 * size
    xs = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(xs**2) / (2 * sigma * sigma))
    k2 = np.outer(k, k)
    return (k2 / k2.sum()).astype(np.float32)


class SpatialWithinChannelLRN(Module):
    """LRN within each channel over a spatial window
    (``nn/SpatialWithinChannelLRN.scala``)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75):
        super().__init__()
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        if x.ndim == 3:
            return within_channel_lrn(x[None], self.size, self.alpha,
                                      self.beta)[0]
        if x.ndim == 4:
            return within_channel_lrn(x, self.size, self.alpha, self.beta)
        # other ranks: the window-mean version on every device, as in the
        # JAX package (normalization.py:238-247), which has no kernel
        half = (self.size - 1) // 2
        pad = (half, self.size - 1 - half)
        sq = F.pad(x * x, pad + pad)
        window_sum = sq.unfold(-2, self.size, 1).unfold(-2, self.size, 1) \
            .sum((-2, -1))
        scale = 1.0 + window_sum / (self.size * self.size) * self.alpha
        return x * torch.pow(scale, -self.beta)


def _smoothing_kernel(kernel: Optional[np.ndarray]) -> torch.Tensor:
    """The layer's kernel buffer: the 9 x 9 Gaussian by default, a 1-D
    kernel as its outer product, divided by its sum (f32)."""
    k = np.asarray(kernel, np.float32) if kernel is not None \
        else _gaussian_kernel(9)
    if k.ndim == 1:
        k = np.outer(k, k)
    return torch.from_numpy(k / k.sum())


def _per_image(op, x, *args):
    """``op`` over NCHW, with a 3-D CHW input as a batch of one."""
    if x.ndim == 3:
        return op(x[None], *args)[0]
    return op(x, *args)


class SpatialSubtractiveNormalization(Module):
    """Subtract a kernel-weighted local mean
    (``nn/SpatialSubtractiveNormalization.scala``)."""

    def __init__(self, n_input_plane: int = 1,
                 kernel: Optional[np.ndarray] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.register_buffer("kernel", _smoothing_kernel(kernel))

    def forward(self, x):
        return _per_image(subtractive_norm, x, self.kernel)


class SpatialDivisiveNormalization(Module):
    """Divide by the local standard deviation
    (``nn/SpatialDivisiveNormalization.scala``)."""

    def __init__(self, n_input_plane: int = 1,
                 kernel: Optional[np.ndarray] = None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.register_buffer("kernel", _smoothing_kernel(kernel))
        self.threshold, self.thresval = threshold, thresval

    def forward(self, x):
        return _per_image(divisive_norm, x, self.kernel, self.threshold,
                          self.thresval)


class SpatialContrastiveNormalization(Module):
    """Subtractive then divisive normalization
    (``nn/SpatialContrastiveNormalization.scala``); its children ``sub``
    and ``div`` each hold the kernel, so the state keys are
    ``sub.kernel`` and ``div.kernel``, as in the JAX package."""

    def __init__(self, n_input_plane: int = 1,
                 kernel: Optional[np.ndarray] = None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def forward(self, x):
        return self.div(self.sub(x))


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

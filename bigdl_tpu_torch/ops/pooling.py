"""Argmax-index max pooling: the backward kernel's wrapper, its plain
PyTorch version, the gate, and the autograd function (the port of
``bigdl_tpu/ops/pooling_pallas.py``: ``maxpool_argmax``, Pallas kernel
``_bwd_kernel``).

    y, idx = the window maximum and the int8 tap index dh*kw + dw of its
             first maximum (ties to the first tap in (dh, dw) order, the
             reference's first-argmax; NaN wins; a padding tap never
             wins)
    dx[q]  = sum over the windows o that hold q and whose idx[o] is q's
             tap of gy[o]

The forward is ``ops/pool.py``'s :func:`~bigdl_tpu_torch.ops.pool.
maxpool_forward` with ``want_index`` (kernel ``csrc/maxpool_fwd.cu``),
which gives the ``y`` and ``idx`` of the JAX package's packed-u32
``reduce_window`` (``_fwd_packed``); without a gradient to take it
writes no index, as the JAX primal computes none.  The backward reads
``gy`` and ``idx`` and never ``x`` or ``y``; the saved index is int8,
an eighth of the int64 indices ``F.max_pool2d`` saves.

One deliberate difference from the JAX kernel: the backward selects
``gy`` where the index matches, where the Pallas kernel multiplies by a
0/1 mask (a Mosaic workaround that leaks NaN into a window's other taps
when ``gy`` is not finite, 0 * inf).  Here an inf gradient stays on its
winner.

The JAX switch ``BIGDL_POOL_KERNEL`` becomes the ``enabled`` argument of
:func:`pool_kernel_supported` (the layer's ``argmax_index``, the
``--pool-kernel`` flag of ``cli perf``).  A CUDA tensor launches the
kernels or raises; a CPU tensor runs the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from bigdl_tpu_torch.ops.pool import (MAX_KERNEL_DTYPES, MAX_TAPS, Pads,
                                      _check_32bit, _out_sizes, _taps,
                                      maxpool_forward)

__all__ = ["maxpool_argmax", "pool_kernel_supported",
           "maxpool_argmax_backward", "maxpool_argmax_backward_plain"]

#: the 16-bit dtypes the JAX path takes (f32 would need a u64 pack there)
ARGMAX_DTYPES = (torch.bfloat16, torch.float16)


def pool_kernel_supported(x: torch.Tensor, dims, strides, pads: Pads,
                          enabled: bool) -> bool:
    """True when the argmax path is ``enabled`` and (x, window) is one
    the JAX package sends down it (``pallas_pool_supported``,
    ``pooling_pallas.py:71-115``): 4-D NCHW input, the window and stride
    on the trailing (H, W) axes with no padding elsewhere, bf16 or f16
    (f32 takes the default path, as in JAX), 1 to 64 taps, and a padded
    extent of at most 256 per axis.  The JAX gate's TPU-only terms are
    dropped: the VMEM estimate (``_bwd_est``) and the lane rule
    ``n * c % 8``.  The path JAX falls back to for them has the same
    first-argmax semantics, so dropping them changes no result."""
    if not enabled:
        return False
    if x.ndim != 4 or x.dtype not in ARGMAX_DTYPES:
        return False
    if tuple(dims[:2]) != (1, 1) or tuple(strides[:2]) != (1, 1):
        return False
    if tuple(pads[0]) != (0, 0) or tuple(pads[1]) != (0, 0):
        return False
    kh, kw = dims[2], dims[3]
    if kh < 1 or kw < 1 or kh * kw > MAX_TAPS:
        return False
    (lo_h, hi_h), (lo_w, hi_w) = pads[2], pads[3]
    # the JAX low-8 coordinate code wraps at padded position 256
    return lo_h + x.shape[2] + hi_h <= 256 and lo_w + x.shape[3] + hi_w <= 256


def maxpool_argmax_backward_plain(gy: torch.Tensor, idx: torch.Tensor,
                                  x_shape, dims, strides,
                                  pads: Pads) -> torch.Tensor:
    """dx from ``gy`` and the int8 tap index on any device: every tap
    scatters ``gy`` where the index names it.  Taps in row-major order
    reach each input in the Pallas residue order (``jh`` outer, ``jw``
    inner); the sum runs in f32 and is rounded once to ``gy``'s dtype,
    as the kernel does."""
    out = list(gy.shape)
    g = gy.to(torch.float32)
    zero = torch.zeros((), device=gy.device)
    dxp = torch.zeros([lo + n + hi for (lo, hi), n in zip(pads, x_shape)],
                      dtype=torch.float32, device=gy.device)
    for t, acc in enumerate(_taps(dxp, dims, strides, out)):
        acc += torch.where(idx == t, g, zero)
    dx = dxp[tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, x_shape))]
    return dx.to(gy.dtype)


def maxpool_argmax_backward(gy: torch.Tensor, idx: torch.Tensor, x_shape,
                            dims: Sequence[int], strides: Sequence[int],
                            pads: Pads) -> torch.Tensor:
    """dx of argmax-index max pooling.  A CUDA tensor launches the
    kernel (``csrc/maxpool_argmax_bwd.cu``: one launch whose CTAs stage
    a group of whole planes, or a band of rows of one plane, of ``gy``
    and the index in shared memory, gather dx into a shared tile and
    write it back with 16-byte stores) or raises, also for rows too wide
    for a one-row band to fit a CTA's shared memory; a CPU tensor runs
    :func:`maxpool_argmax_backward_plain`."""
    if gy.device.type == "cpu":
        return maxpool_argmax_backward_plain(gy, idx, x_shape, dims, strides,
                                             pads)
    if gy.device.type != "cuda":
        raise RuntimeError(f"no max-pool kernel for device {gy.device}")
    from bigdl_tpu_torch.ops import _build

    if len(x_shape) != 4 or tuple(dims[:2]) != (1, 1) \
            or tuple(strides[:2]) != (1, 1):
        raise ValueError("argmax backward kernel takes a 4-D NCHW pooling "
                         "over (H, W)")
    if gy.dtype not in MAX_KERNEL_DTYPES or idx.dtype != torch.int8:
        raise TypeError(f"argmax backward kernel takes gy of "
                        f"{sorted(map(str, MAX_KERNEL_DTYPES))} and an int8 "
                        f"index, got {gy.dtype} and {idx.dtype}")
    if not (gy.is_contiguous() and idx.is_contiguous()):
        raise ValueError("argmax backward kernel takes contiguous NCHW "
                         "tensors")
    n, c, h, w = x_shape
    out = [n, c] + _out_sizes(x_shape, dims, strides, pads)[2:]
    if list(gy.shape) != out or list(idx.shape) != out:
        raise ValueError(f"gy {tuple(gy.shape)} and idx {tuple(idx.shape)} "
                         f"do not match the pooling of {tuple(x_shape)}")
    _check_32bit(x_shape)
    oh, ow = out[2:]
    lib = _build.library("maxpool_argmax_bwd")
    dx = torch.empty(tuple(x_shape), dtype=gy.dtype, device=gy.device)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(gy.device):
        stream = torch.cuda.current_stream(gy.device).cuda_stream
        err = lib.bigdl_maxpool_argmax_bwd(
            ctypes.c_void_p(gy.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(dx.data_ptr()), n * c, h, w, oh, ow, dims[2],
            dims[3], strides[2], strides[3], pads[2][0], pads[3][0],
            MAX_KERNEL_DTYPES[gy.dtype], ctypes.c_void_p(stream))
    _build.check(lib, err, "argmax max-pool backward")
    maxpool_argmax_backward.launches += 1
    return dx


#: kernel launches made by this wrapper (and nowhere else)
maxpool_argmax_backward.launches = 0


class _MaxPoolArgmax(torch.autograd.Function):
    """Saves the int8 index alone (``_vjp_fwd``, ``pooling_pallas.py:
    378-380``)."""

    @staticmethod
    def forward(ctx, x, dims, strides, pads):
        y, idx = maxpool_forward(x, dims, strides, pads, want_index=True)
        ctx.save_for_backward(idx)
        ctx.x_shape = tuple(x.shape)
        ctx.geom = (dims, strides, pads)
        return y

    @staticmethod
    def backward(ctx, gy):
        (idx,) = ctx.saved_tensors
        dx = maxpool_argmax_backward(gy.contiguous(), idx, ctx.x_shape,
                                     *ctx.geom)
        return dx, None, None, None


def maxpool_argmax(x: torch.Tensor, dims: Sequence[int],
                   strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """Differentiable max pooling over the trailing (H, W) axes of an
    NCHW tensor whose gradient goes to each window's first maximum via
    a saved int8 tap index.  Values and tie order equal the default path
    (``F.max_pool2d`` over the -inf padded input) under
    :func:`pool_kernel_supported`.  Without a gradient to take it is one
    forward launch that writes no index."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPoolArgmax.apply(x, dims, strides, pads)
    return maxpool_forward(x, dims, strides, pads)

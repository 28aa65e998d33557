"""Torch-semantics average pooling: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd function that joins them (the
port of ``bigdl_tpu/ops/pool_pallas.py`` ``avg_pool``, Pallas kernels
``_avg_fwd_kernel`` and ``_avg_bwd_kernel``).

    y[o]  = (sum of the window's taps, zero padding, order (dh, dw)) * inv[o]
    dx[q] = sum over the windows o that hold the padded position q of
            wgt[o],  wgt = gy * inv               (the exact transpose)

``inv`` is the reciprocal divisor map of :func:`_np_inv_counts`, copied
from the JAX package: under ``count_include_pad`` the declared padding
counts toward the divisor and the ceil overflow never does.  It is pure
geometry, computed in float64 numpy once per shape and handed to the
kernel as a small f32 device tensor.

Routing mirrors the JAX package minus its TPU-only conditions (VMEM
budget, Mosaic dtypes, the unroll bound on taps): 4-D input pooled over
its trailing (H, W) axes goes to the kernel on a CUDA tensor and to the
plain version on a CPU tensor; other ranks run the plain version on
every device.  A CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["avg_pool", "avg_pool_forward", "avg_pool_plain",
           "avg_pool_backward", "avg_pool_backward_plain", "window_sum",
           "KERNEL_DTYPES"]

#: dtypes the kernel reads and writes (its sums are f32)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Pads = Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=256)
def _np_inv_counts(shape, dims, strides, pads, declared,
                   count_include_pad: bool):
    """Reciprocal divisor map, broadcast-shaped (copied from
    ``pool_pallas.py:366-397``): per windowed axis, the overlap of each
    window with the counted region — data plus declared padding under
    ``count_include_pad`` (ceil-overflow padding never counts:
    ``SpatialAveragePooling.scala:133-135``), data only otherwise.
    Separable, so the map is an outer product over the windowed axes
    with extent 1 on the rest."""
    axis_counts = []
    bshape = []
    for n, k, s, (lo, hi), (dlo, dhi) in zip(shape, dims, strides, pads,
                                             declared):
        p = lo + n + hi
        out = (p - k) // s + 1
        if k == 1 and s == 1 and lo == 0 and hi == 0:
            bshape.append(1)
            continue
        if count_include_pad:
            start, end = 0, dlo + n + dhi  # declared lo == lo always
        else:
            start, end = lo, lo + n
        o = np.arange(out)
        cnt = (np.minimum(o * s + k, end)
               - np.maximum(o * s, start)).clip(min=0)
        axis_counts.append(cnt.astype(np.float64))
        bshape.append(out)
    if not axis_counts:
        return np.ones(bshape)
    counts = functools.reduce(np.multiply.outer, axis_counts)
    return (1.0 / np.maximum(counts, 1.0)).reshape(bshape)


def _out_sizes(shape, dims, strides, pads):
    return [(lo + n + hi - k) // s + 1
            for n, k, s, (lo, hi) in zip(shape, dims, strides, pads)]


def window_sum(x: torch.Tensor, dims: Sequence[int],
               strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """Zero-padded strided window sum over every axis of ``x`` (the JAX
    package's ``reduce_window(add)``), in ``x``'s dtype, summing the
    taps in row-major window order."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    xp = F.pad(x, flat)
    out = _out_sizes(x.shape, dims, strides, pads)
    s = None
    for off in itertools.product(*[range(k) for k in dims]):
        tap = xp[tuple(slice(o, o + (m - 1) * st + 1, st)
                       for o, m, st in zip(off, out, strides))]
        s = tap if s is None else s + tap
    return s


def avg_pool_plain(x: torch.Tensor, dims, strides, pads: Pads, inv):
    """The window sum times the inverse-count map, on any device; 16-bit
    inputs sum in f32 and round the result, as the kernel does."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    y = window_sum(xf, dims, strides, pads) \
        * torch.as_tensor(inv, dtype=xf.dtype, device=x.device)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _device_inv(key, device: torch.device) -> torch.Tensor:
    """The full [oh, ow] f32 inverse-count plane the kernel indexes, on
    ``device``, made once per geometry (a host-to-device copy per call
    would stall the stream).  An axis the window leaves alone (k 1,
    stride 1, no padding) has extent 1 in the broadcast map and is
    spread to its output extent here."""
    oh, ow = _out_sizes(*key[:4])[2:]
    plane = np.broadcast_to(_np_inv_counts(*key)[0, 0], (oh, ow))
    return torch.as_tensor(np.array(plane, np.float32, order="C"),
                           device=device)


@functools.lru_cache(maxsize=64)
def _inv_tensor(key, device: torch.device, dtype: torch.dtype):
    """The broadcast-shaped inverse-count map on ``device`` in ``dtype``,
    made once per geometry."""
    return torch.as_tensor(_np_inv_counts(*key), dtype=dtype, device=device)


def _kernel_supported(x: torch.Tensor, dims, strides, inv) -> bool:
    """Structural gate, the JAX ``pool_plane_supported`` minus its
    TPU-only checks: 4-D, window and stride on the trailing (H, W) axes
    only, a floating dtype, and a divisor map that is one [oh, ow]
    plane."""
    return (x.ndim == 4 and tuple(dims[:2]) == (1, 1)
            and tuple(strides[:2]) == (1, 1) and x.is_floating_point()
            and inv.shape[:2] == (1, 1))


def _launch(x: torch.Tensor, key, dims, strides, pads) -> torch.Tensor:
    from bigdl_tpu_torch.ops import _build

    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"average-pool kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("average-pool kernel takes a contiguous NCHW tensor")
    n, c, h, w = x.shape
    oh, ow = _out_sizes(x.shape, dims, strides, pads)[2:]
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    inv = _device_inv(key, x.device)
    lib = _build.library("avg_pool_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_avg_pool_fwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(inv.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), n * c, h, w, oh, ow,
            dims[2], dims[3], strides[2], strides[3], pads[2][0], pads[3][0],
            KERNEL_DTYPES[x.dtype], ctypes.c_void_p(stream))
    _build.check(lib, err, "average-pool forward")
    avg_pool_forward.launches += 1
    return y


def avg_pool_forward(x: torch.Tensor, dims: Sequence[int],
                     strides: Sequence[int], pads: Pads, declared: Pads,
                     count_include_pad: bool) -> torch.Tensor:
    """Torch-semantics average pooling with per-axis ``dims``,
    ``strides`` and asymmetric ``pads`` (ceil mode is the caller's
    ``hi``); ``declared`` is the user-declared part of the padding.  A
    CUDA tensor launches the kernel (``csrc/avg_pool_fwd.cu``) or
    raises; a CPU tensor runs :func:`avg_pool_plain`."""
    key = (tuple(x.shape), tuple(dims), tuple(strides),
           tuple(map(tuple, pads)), tuple(map(tuple, declared)),
           bool(count_include_pad))
    inv = _np_inv_counts(*key)
    if not _kernel_supported(x, dims, strides, inv) or x.device.type == "cpu":
        return avg_pool_plain(x, dims, strides, pads, inv)
    if x.device.type != "cuda":
        raise RuntimeError(f"no average-pool kernel for device {x.device}")
    return _launch(x, key, dims, strides, pads)


#: kernel launches made by this wrapper (and nowhere else)
avg_pool_forward.launches = 0


def avg_pool_backward_plain(wgt: torch.Tensor, x_shape, dims, strides,
                            pads: Pads, dtype: torch.dtype) -> torch.Tensor:
    """dx of the window sum from the out-grid weights ``wgt`` on any
    device, after ``_avg_bwd_xla``: dilate ``wgt`` by the strides,
    edge-pad it by k-1, take the stride-1 window sum, and slice off the
    padding (input positions no window reaches get 0).  16-bit weights
    sum in f32 and round dx to ``dtype``, as the kernel does."""
    wf = wgt.float() if wgt.dtype in (torch.bfloat16, torch.float16) else wgt
    dil = wf.new_zeros([(o - 1) * s + 1 for o, s in zip(wf.shape, strides)])
    dil[tuple(slice(None, None, s) for s in strides)] = wf
    full = window_sum(dil, dims, (1,) * len(dims),
                      tuple((k - 1, k - 1) for k in dims))
    # full covers padded positions [0, (o-1)*s + k); a floor-mode tail
    # past the last window reads zeros
    tail = [max(0, lo + n - f) for (lo, _), n, f
            in zip(pads, x_shape, full.shape)]
    if any(tail):
        flat = []
        for t in reversed(tail):
            flat += [0, t]
        full = F.pad(full, flat)
    dx = full[tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, x_shape))]
    return dx.to(dtype)


def avg_pool_backward(wgt: torch.Tensor, x_shape, dims, strides,
                      pads: Pads, dtype: torch.dtype) -> torch.Tensor:
    """dx of the window sum from the out-grid weights ``wgt``.  A CUDA
    tensor launches the kernel (``csrc/avg_pool_bwd.cu``) or raises; a
    CPU tensor, or a geometry the kernel does not take by structure,
    runs :func:`avg_pool_backward_plain`."""
    supported = (len(x_shape) == 4 and tuple(dims[:2]) == (1, 1)
                 and tuple(strides[:2]) == (1, 1))
    if not supported or wgt.device.type == "cpu":
        return avg_pool_backward_plain(wgt, x_shape, dims, strides, pads,
                                       dtype)
    if wgt.device.type != "cuda":
        raise RuntimeError(f"no average-pool kernel for device {wgt.device}")
    from bigdl_tpu_torch.ops import _build

    if wgt.dtype not in KERNEL_DTYPES or dtype != wgt.dtype:
        raise TypeError(f"average-pool backward kernel takes one dtype of "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got "
                        f"{wgt.dtype} -> {dtype}")
    if not wgt.is_contiguous():
        raise ValueError("average-pool backward kernel takes a contiguous "
                         "NCHW gradient")
    n, c, h, w = x_shape
    oh, ow = wgt.shape[2:]
    if tuple(wgt.shape[:2]) != (n, c) \
            or [oh, ow] != _out_sizes(x_shape, dims, strides, pads)[2:]:
        raise ValueError(f"gradient of shape {tuple(wgt.shape)} does not "
                         f"match the pooling of {tuple(x_shape)}")
    dx = torch.empty(tuple(x_shape), dtype=dtype, device=wgt.device)
    if dx.numel() == 0:
        return dx
    lib = _build.library("avg_pool_bwd")
    with torch.cuda.device(wgt.device):
        stream = torch.cuda.current_stream(wgt.device).cuda_stream
        err = lib.bigdl_avg_pool_bwd(
            ctypes.c_void_p(wgt.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
            n * c, h, w, oh, ow, dims[2], dims[3], strides[2], strides[3],
            pads[2][0], pads[3][0], KERNEL_DTYPES[dtype],
            ctypes.c_void_p(stream))
    _build.check(lib, err, "average-pool backward")
    avg_pool_backward.launches += 1
    return dx


#: kernel launches made by this wrapper (and nowhere else)
avg_pool_backward.launches = 0


class _AvgPool(torch.autograd.Function):
    """The op is linear in x: the forward keeps only x's shape and dtype
    (``pool_pallas.py:472-478``); the backward forms ``wgt = gy * inv``
    in gy's dtype and launches the kernel (``_avg_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, dims, strides, pads, declared, count_include_pad):
        ctx.key = (tuple(x.shape), tuple(dims), tuple(strides),
                   tuple(map(tuple, pads)), tuple(map(tuple, declared)),
                   bool(count_include_pad))
        ctx.x_dtype = x.dtype
        return avg_pool_forward(x, dims, strides, pads, declared,
                                count_include_pad)

    @staticmethod
    def backward(ctx, gy):
        x_shape, dims, strides, pads = ctx.key[:4]
        wgt = (gy * _inv_tensor(ctx.key, gy.device, gy.dtype)).contiguous()
        dx = avg_pool_backward(wgt, x_shape, dims, strides, pads, ctx.x_dtype)
        return dx, None, None, None, None, None


def avg_pool(x: torch.Tensor, dims: Sequence[int], strides: Sequence[int],
             pads: Pads, declared: Pads, count_include_pad: bool
             ) -> torch.Tensor:
    """Differentiable Torch-semantics average pooling (see
    :func:`avg_pool_forward`).  Without a gradient to take it is one
    forward launch."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AvgPool.apply(x, dims, strides, pads, declared,
                              count_include_pad)
    return avg_pool_forward(x, dims, strides, pads, declared,
                            count_include_pad)

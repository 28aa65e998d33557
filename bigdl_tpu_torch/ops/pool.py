"""Torch-semantics average pooling and tie-split max pooling: the CUDA
kernels' wrappers, their plain PyTorch versions, and the autograd
functions that join them (the port of ``bigdl_tpu/ops/pool_pallas.py``:
``avg_pool`` with Pallas kernels ``_avg_fwd_kernel`` and
``_avg_bwd_kernel``, ``maxpool_tie_split`` with ``_maxpool_fwd_kernel``
and ``_tie_bwd_kernel``).

    y[o]  = (sum of the window's taps, zero padding, order (dh, dw)) * inv[o]
    dx[q] = sum over the windows o that hold the padded position q of
            wgt[o],  wgt = gy * inv               (the exact transpose)

``inv`` is the reciprocal divisor map of :func:`_np_inv_counts`, copied
from the JAX package: under ``count_include_pad`` the declared padding
counts toward the divisor and the ceil overflow never does.  It is pure
geometry, computed in float64 numpy once per shape and handed to the
kernel as a small f32 device tensor.

Max pooling with the equal tie split (``split_ties()``):

    y[o]  = the window maximum (-inf padding; NaN propagates)
    dx[q] = sum over the windows o that hold q with x[q] == y[o] of
            gy[o] / cnt[o],  cnt[o] = taps of window o equal to y[o]

so each window's gradient is shared equally by its tied maxima and the
gradient mass is conserved.  The forward kernel (``maxpool_fwd.cu``,
wrapper :func:`maxpool_forward`) also serves the argmax mode of
``ops/pooling.py``, where it writes the int8 index of the first maximum
beside ``y``.

Routing mirrors the JAX package minus its TPU-only conditions (VMEM
budget, Mosaic dtypes, and for the average pool the unroll bound on
taps): 4-D input pooled over its trailing (H, W) axes (at most 64 taps
for the max pool, the JAX ``pool_plane_supported`` gate) goes to the
kernel on a CUDA tensor and to the plain version on a CPU tensor; other
ranks run the plain version on every device, as the JAX XLA leg does.
The kernels take f32 and bf16 (the average pool) or f32, bf16 and f16
(the max pool); a CUDA tensor of another dtype, or one the kernel cannot
take otherwise, raises.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["avg_pool", "avg_pool_forward", "avg_pool_plain",
           "avg_pool_backward", "avg_pool_backward_plain", "window_sum",
           "maxpool_tie_split", "maxpool_forward", "maxpool_forward_plain",
           "maxpool_tie_split_backward", "maxpool_tie_split_backward_plain",
           "KERNEL_DTYPES", "MAX_KERNEL_DTYPES"]

#: dtypes the average-pool kernels read and write (their sums are f32)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dtypes the max-pool kernels read and write (their sums are f32)
MAX_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the JAX gate's bound on a max-pool window (``pool_pallas.py:58``)
MAX_TAPS = 64

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


def _pad(x: torch.Tensor, pads: Pads, value=0.0) -> torch.Tensor:
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _taps(xp: torch.Tensor, dims, strides, out):
    """Every window tap of the padded ``xp`` as a strided view of the
    output's shape, in row-major window order (``_taps`` of the JAX
    package, over every axis)."""
    for off in itertools.product(*[range(k) for k in dims]):
        yield xp[tuple(slice(o, o + (m - 1) * st + 1, st)
                       for o, m, st in zip(off, out, strides))]


def window_sum(x: torch.Tensor, dims: Sequence[int],
               strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """Zero-padded strided window sum over every axis of ``x`` (the JAX
    package's ``reduce_window(add)``), in ``x``'s dtype, summing the
    taps in row-major window order."""
    s = None
    for tap in _taps(_pad(x, pads), dims, strides,
                     _out_sizes(x.shape, dims, strides, pads)):
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
    tensor launches the kernel (``csrc/avg_pool_bwd.cu``: groups of
    planes staged in shared memory where a plane's ``wgt`` and dx fit
    32 KB, an element a thread otherwise, both bit-equal to the plain
    version) or
    raises; a CPU tensor, or a geometry the kernel does not take by
    structure, runs :func:`avg_pool_backward_plain`."""
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


# ---------------------------------------------------------------------------
# tie-split max pooling
# ---------------------------------------------------------------------------

def _max_plane_supported(x: torch.Tensor, dims, strides) -> bool:
    """Structural gate, the JAX ``pool_plane_supported`` (``:72-96``)
    minus its TPU-only checks (the VMEM budget and the Mosaic dtypes):
    4-D, window and stride on the trailing (H, W) axes only, at most
    :data:`MAX_TAPS` taps, a floating dtype."""
    return (x.ndim == 4 and tuple(dims[:2]) == (1, 1)
            and tuple(strides[:2]) == (1, 1)
            and dims[2] * dims[3] <= MAX_TAPS and x.is_floating_point())


def maxpool_forward_plain(x: torch.Tensor, dims, strides, pads: Pads,
                          want_index: bool = False):
    """The window maximum over every axis of ``x`` on any device, by the
    kernel's rule: taps in row-major window order, a tap outside ``x``
    never wins, and a tap wins over the best so far when it is the first
    inside ``x``, a NaN over a non-NaN, or strictly greater.  So NaN
    propagates (the first NaN wins), -0.0 ties with +0.0, ties go to the
    first tap, and ``y`` keeps the winner's own bits.  With
    ``want_index`` it also returns the winner's row-major tap number
    (``dh * kw + dw`` on a 4-D (H, W) window) as int8, -1 for a window
    with no tap inside ``x`` (whose ``y`` is -inf)."""
    taps = math.prod(dims)
    if want_index and taps > 127:
        raise ValueError(f"an int8 tap index needs at most 127 taps, "
                         f"got {taps}")
    out = _out_sizes(x.shape, dims, strides, pads)
    xs = _taps(_pad(x, pads, -math.inf), dims, strides, out)
    inside = _taps(_pad(torch.ones(x.shape, dtype=torch.bool,
                                   device=x.device), pads, False),
                   dims, strides, out)
    best = torch.full(out, -math.inf, dtype=x.dtype, device=x.device)
    idx = torch.full(out, -1, dtype=torch.int64, device=x.device)
    for t, (tap, ok) in enumerate(zip(xs, inside)):
        beats = (idx < 0) | (~torch.isnan(best)
                             & (torch.isnan(tap) | (tap > best)))
        take = ok & beats
        best = torch.where(take, tap, best)
        idx = torch.where(take, t, idx)
    return (best, idx.to(torch.int8)) if want_index else best


def _check_32bit(x_shape) -> None:
    """The max-pool kernels index in 32 bits: an input (which is never
    smaller than its output) of 2^31 elements or more is refused."""
    if math.prod(x_shape) >= 2 ** 31:
        raise ValueError(f"max-pool kernels take fewer than 2^31 elements, "
                         f"got {tuple(x_shape)}")


def _launch_maxpool_fwd(x: torch.Tensor, dims, strides, pads: Pads,
                        want_index: bool):
    from bigdl_tpu_torch.ops import _build

    if x.dtype not in MAX_KERNEL_DTYPES:
        raise TypeError(f"max-pool kernel takes "
                        f"{sorted(map(str, MAX_KERNEL_DTYPES))}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("max-pool kernel takes a contiguous NCHW tensor")
    _check_32bit(x.shape)
    n, c, h, w = x.shape
    oh, ow = _out_sizes(x.shape, dims, strides, pads)[2:]
    lib = _build.library("maxpool_fwd")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, c, oh, ow), dtype=torch.int8, device=x.device) \
        if want_index else None
    if y.numel() == 0:
        return (y, idx) if want_index else y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_maxpool_fwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(idx.data_ptr() if want_index else None),
            n * c, h, w, oh, ow, dims[2], dims[3], strides[2], strides[3],
            pads[2][0], pads[3][0], MAX_KERNEL_DTYPES[x.dtype],
            ctypes.c_void_p(stream))
    _build.check(lib, err, "max-pool forward")
    maxpool_forward.launches += 1
    return (y, idx) if want_index else y


def maxpool_forward(x: torch.Tensor, dims: Sequence[int],
                    strides: Sequence[int], pads: Pads,
                    want_index: bool = False):
    """Max pooling with per-axis ``dims``, ``strides`` and asymmetric
    ``pads`` (ceil mode is the caller's ``hi``): ``y``, and with
    ``want_index`` also the int8 tap index of each window's first
    maximum (see :func:`maxpool_forward_plain`).  It is the tie-split
    forward (no index) and the argmax-mode forward (index).  A CUDA
    tensor that passes the structural gate launches the kernel
    (``csrc/maxpool_fwd.cu``: one launch whose CTAs stage a group of
    whole planes, or the rows of ``x`` under a band of output rows of
    one plane, in shared memory, take the window maxima there, 3x3
    windows of stride 1 or 2 as strips of 8 outputs a thread, and write
    ``y`` and the index back with 16-byte stores; rows too wide to stage
    take a one-thread-per-output kernel; it allocates nothing beyond
    ``y`` and the index) or raises; a CPU tensor, or another geometry,
    runs :func:`maxpool_forward_plain`."""
    if not _max_plane_supported(x, dims, strides) or x.device.type == "cpu":
        return maxpool_forward_plain(x, dims, strides, pads, want_index)
    if x.device.type != "cuda":
        raise RuntimeError(f"no max-pool kernel for device {x.device}")
    return _launch_maxpool_fwd(x, dims, strides, pads, want_index)


#: kernel launches made by this wrapper (and nowhere else)
maxpool_forward.launches = 0


def maxpool_tie_split_backward_plain(x: torch.Tensor, y: torch.Tensor,
                                     gy: torch.Tensor, dims, strides,
                                     pads: Pads) -> torch.Tensor:
    """dx of tie-split max pooling on any device and any rank: the tie
    count of each window (taps outside ``x`` read -inf, as the JAX pad),
    ``wgt = gy / cnt`` where ``cnt > 0`` else 0, then every tap scatters
    ``wgt`` where it equals ``y``.  Taps in row-major order reach each
    input in the Pallas residue order (``jh`` outer, ``jw`` inner), and
    the sum runs in f32 and is rounded once to ``x``'s dtype, as the
    kernel does."""
    out = list(y.shape)
    xp = _pad(x, pads, -math.inf)
    cnt = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for tap in _taps(xp, dims, strides, out):
        cnt += tap == y
    g = gy.to(torch.float32)
    wgt = torch.where(cnt > 0, g / cnt, torch.zeros((), device=g.device))
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    for tap, acc in zip(_taps(xp, dims, strides, out),
                        _taps(dxp, dims, strides, out)):
        acc += torch.where(tap == y, wgt, torch.zeros((), device=g.device))
    dx = dxp[tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, x.shape))]
    return dx.to(x.dtype)


def maxpool_tie_split_backward(x: torch.Tensor, y: torch.Tensor,
                               gy: torch.Tensor, dims: Sequence[int],
                               strides: Sequence[int],
                               pads: Pads) -> torch.Tensor:
    """dx of tie-split max pooling from the saved ``x`` and ``y``.  A
    CUDA tensor that passes the structural gate launches the kernel
    (``csrc/maxpool_tie_bwd.cu``: one launch whose CTAs stage a group of
    whole planes, or a band of rows of one plane, of ``x``, ``y`` and
    ``gy`` in shared memory, weight the outputs there, gather each
    input's dx there and write it back with 16-byte stores; it allocates
    nothing beyond ``dx``) or raises, also for rows too wide for a
    one-row band to fit a CTA's shared memory (several thousand
    elements); a CPU tensor, or another geometry, runs
    :func:`maxpool_tie_split_backward_plain`."""
    if not _max_plane_supported(x, dims, strides) or x.device.type == "cpu":
        return maxpool_tie_split_backward_plain(x, y, gy, dims, strides, pads)
    if x.device.type != "cuda":
        raise RuntimeError(f"no max-pool kernel for device {x.device}")
    from bigdl_tpu_torch.ops import _build

    if x.dtype not in MAX_KERNEL_DTYPES or y.dtype != x.dtype \
            or gy.dtype != x.dtype:
        raise TypeError(f"tie-split backward kernel takes x, y and gy of one "
                        f"dtype of {sorted(map(str, MAX_KERNEL_DTYPES))}, got "
                        f"{x.dtype}, {y.dtype}, {gy.dtype}")
    if not (x.is_contiguous() and y.is_contiguous() and gy.is_contiguous()):
        raise ValueError("tie-split backward kernel takes contiguous NCHW "
                         "tensors")
    n, c, h, w = x.shape
    out = [n, c] + _out_sizes(x.shape, dims, strides, pads)[2:]
    if list(y.shape) != out or list(gy.shape) != out:
        raise ValueError(f"y {tuple(y.shape)} and gy {tuple(gy.shape)} do not "
                         f"match the pooling of {tuple(x.shape)}")
    _check_32bit(x.shape)
    oh, ow = out[2:]
    lib = _build.library("maxpool_tie_bwd")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_maxpool_tie_bwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(gy.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
            n * c, h, w, oh, ow, dims[2], dims[3], strides[2], strides[3],
            pads[2][0], pads[3][0], MAX_KERNEL_DTYPES[x.dtype],
            ctypes.c_void_p(stream))
    _build.check(lib, err, "tie-split max-pool backward")
    maxpool_tie_split_backward.launches += 1
    return dx


#: kernel launches made by this wrapper (and nowhere else)
maxpool_tie_split_backward.launches = 0


class _MaxPoolTieSplit(torch.autograd.Function):
    """Saves ``x`` and ``y`` for the backward, as ``_tie_vjp_fwd`` does
    (``pool_pallas.py:345-348``)."""

    @staticmethod
    def forward(ctx, x, dims, strides, pads):
        y = maxpool_forward(x, dims, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.geom = (dims, strides, pads)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, y = ctx.saved_tensors
        dx = maxpool_tie_split_backward(x, y, gy.contiguous(), *ctx.geom)
        return dx, None, None, None


def maxpool_tie_split(x: torch.Tensor, dims: Sequence[int],
                      strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """Differentiable max pooling whose gradient is split equally among
    tied maxima (``pool_pallas.py:333-359``), over any rank.  Without a
    gradient to take it is one forward launch."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPoolTieSplit.apply(x, dims, strides, pads)
    return maxpool_forward(x, dims, strides, pads)

"""Torch-semantics average-pool forward: the CUDA kernel's wrapper and
its plain PyTorch version (the port of ``bigdl_tpu/ops/pool_pallas.py``
``avg_pool`` forward, Pallas kernel ``_avg_fwd_kernel``).

    y[o] = (sum of the window's taps, zero padding, order (dh, dw)) * inv[o]

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

__all__ = ["avg_pool_forward", "avg_pool_plain", "window_sum",
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
    """The [oh, ow] f32 inverse-count plane on ``device``, made once per
    geometry (a host-to-device copy per call would stall the stream)."""
    inv = _np_inv_counts(*key)
    return torch.as_tensor(inv[0, 0], dtype=torch.float32,
                           device=device).contiguous()


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

"""Cross-map LRN: the CUDA kernels' wrappers, their plain PyTorch
versions, and the autograd function that joins them (the port of
``bigdl_tpu/ops/lrn_pallas.py`` ``cross_map_lrn``, Pallas kernels
``_cml_fwd_kernel`` and ``_cml_bwd_kernel``).

    den = k + (alpha / n) * sum_{band} x^2     (zero channel halo)
    y   = x * den^-beta                       (rsqrt when beta == 0.5)
    t   = g * x * den^(-beta-1)               (zero channel halo)
    dx  = g * den^-beta - (2 alpha beta / n) * x * sum_{band} t

Both band sums run over the padded channel window in order
d = 0 .. n-1, the order of the Pallas kernels; for an odd band the
transposed window of the backward is the forward's.

Routing mirrors the JAX package minus its TPU-only conditions (VMEM
budget, Mosaic dtypes): 4-D input with an odd band goes to the kernel on
a CUDA tensor and to the plain version on a CPU tensor; anything else
structural (other ranks, even bands) runs the plain version on every
device, as the JAX package runs its XLA leg there.  A CUDA tensor the
kernel cannot take (dtype, layout, band wider than the kernel's
instantiations) raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["cross_map_lrn", "cross_map_lrn_forward", "cross_map_lrn_plain",
           "cross_map_lrn_backward", "cross_map_lrn_backward_plain",
           "KERNEL_DTYPES", "MAX_KERNEL_SIZE"]

#: dtypes the kernel reads and writes (its math is f32)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest band the kernel is instantiated for (odd sizes 1..15)
MAX_KERNEL_SIZE = 15


def _pow(den: torch.Tensor, p: float) -> torch.Tensor:
    """den ** p for den > 0, as ``lrn_pallas._pow`` computes it."""
    if p == -0.5:
        return torch.rsqrt(den)
    return torch.exp(p * torch.log(den))


def cross_map_lrn_plain(x: torch.Tensor, size: int, alpha: float,
                        beta: float, k: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, den) over NCHW ``x`` on any device; 16-bit inputs compute in
    f32 and round the results to their dtype, as the kernel does."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    c = xf.shape[1]
    half = (size - 1) // 2
    sq = F.pad(xf * xf, (0, 0, 0, 0, half, size - 1 - half))
    s = sq[:, 0:c]
    for d in range(1, size):
        s = s + sq[:, d:d + c]
    den = k + s * (alpha / size)
    y = xf * _pow(den, -beta)
    return y.to(x.dtype), den.to(x.dtype)


def _kernel_supported(x: torch.Tensor, size: int) -> bool:
    """Structural gate, the JAX ``cross_map_lrn_supported`` minus its
    TPU-only checks: 4-D NCHW, odd band."""
    return x.ndim == 4 and size >= 1 and size % 2 == 1


def _check_kernel_args(size: int, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"cross-map LRN kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    if any(t.dtype != x.dtype or t.shape != x.shape for t in tensors):
        raise ValueError("cross-map LRN kernel takes tensors of one dtype "
                         "and shape")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cross-map LRN kernel takes a contiguous NCHW tensor")
    if size > MAX_KERNEL_SIZE:
        raise ValueError(f"cross-map LRN kernel is built for odd bands up "
                         f"to {MAX_KERNEL_SIZE}, got {size}")


def _launch(x: torch.Tensor, size: int, alpha: float, beta: float,
            k: float, want_den: bool):
    from bigdl_tpu_torch.ops import _build

    _check_kernel_args(size, x)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    den = torch.empty_like(x) if want_den else None
    if x.numel() == 0:
        return y, den
    lib = _build.library("lrn_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_cml_fwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(den.data_ptr() if den is not None else 0),
            n, c, h * w, size, float(alpha / size), float(beta), float(k),
            KERNEL_DTYPES[x.dtype], ctypes.c_void_p(stream))
    _build.check(lib, err, "cross-map LRN forward")
    cross_map_lrn_forward.launches += 1
    return y, den


def cross_map_lrn_forward(x: torch.Tensor, size: int, alpha: float,
                          beta: float, k: float, want_den: bool = False
                          ) -> Union[torch.Tensor,
                                     Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Cross-map LRN over NCHW ``x``: y, or (y, den) with ``want_den``.
    A CUDA tensor launches the kernel (``csrc/lrn_fwd.cu``) or raises;
    a CPU tensor runs :func:`cross_map_lrn_plain`."""
    if not _kernel_supported(x, size) or x.device.type == "cpu":
        y, den = cross_map_lrn_plain(x, size, alpha, beta, k)
    elif x.device.type == "cuda":
        y, den = _launch(x, size, alpha, beta, k, want_den)
    else:
        raise RuntimeError(f"no cross-map LRN kernel for device {x.device}")
    return (y, den) if want_den else y


#: kernel launches made by this wrapper (and nowhere else)
cross_map_lrn_forward.launches = 0


def cross_map_lrn_backward_plain(x: torch.Tensor, den: torch.Tensor,
                                 g: torch.Tensor, size: int, alpha: float,
                                 beta: float) -> torch.Tensor:
    """dx over NCHW ``x`` from the forward's ``den`` and the output
    gradient ``g``, on any device (``_cml_bwd_xla`` and
    ``_cml_bwd_kernel``); 16-bit inputs compute in f32 and round dx to
    x's dtype, as the kernel does."""
    def f32(a):
        return a.float() if a.dtype in (torch.bfloat16, torch.float16) else a

    xf, df, gf = f32(x), f32(den), f32(g)
    c = xf.shape[1]
    half = (size - 1) // 2
    t = F.pad(gf * xf * _pow(df, -beta - 1.0),
              (0, 0, 0, 0, half, size - 1 - half))
    ts = t[:, 0:c]
    for d in range(1, size):
        ts = ts + t[:, d:d + c]
    dx = gf * _pow(df, -beta) - (2.0 * alpha * beta / size) * xf * ts
    return dx.to(x.dtype)


def cross_map_lrn_backward(x: torch.Tensor, den: torch.Tensor,
                           g: torch.Tensor, size: int, alpha: float,
                           beta: float) -> torch.Tensor:
    """dx of cross-map LRN.  A CUDA tensor launches the kernel
    (``csrc/lrn_bwd.cu``) or raises; a CPU tensor, or a shape the kernel
    does not take by structure, runs
    :func:`cross_map_lrn_backward_plain`."""
    if not _kernel_supported(x, size) or x.device.type == "cpu":
        return cross_map_lrn_backward_plain(x, den, g, size, alpha, beta)
    if x.device.type != "cuda":
        raise RuntimeError(f"no cross-map LRN kernel for device {x.device}")
    from bigdl_tpu_torch.ops import _build

    _check_kernel_args(size, x, den, g)
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    lib = _build.library("lrn_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_cml_bwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(den.data_ptr()),
            ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
            n, c, h * w, size, float(2.0 * alpha * beta / size),
            float(-beta), float(-beta - 1.0), KERNEL_DTYPES[x.dtype],
            ctypes.c_void_p(stream))
    _build.check(lib, err, "cross-map LRN backward")
    cross_map_lrn_backward.launches += 1
    return dx


#: kernel launches made by this wrapper (and nowhere else)
cross_map_lrn_backward.launches = 0


class _CrossMapLRN(torch.autograd.Function):
    """Forward keeps ``(x, den)``; backward is the kernel (the JAX
    ``custom_vjp``, ``lrn_pallas.py:245-272``)."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        y, den = cross_map_lrn_forward(x, size, alpha, beta, k, want_den=True)
        ctx.save_for_backward(x, den)
        ctx.hyper = (size, alpha, beta)
        return y

    @staticmethod
    def backward(ctx, g):
        x, den = ctx.saved_tensors
        dx = cross_map_lrn_backward(x, den, g.contiguous(), *ctx.hyper)
        return dx, None, None, None, None


def cross_map_lrn(x: torch.Tensor, size: int, alpha: float, beta: float,
                  k: float) -> torch.Tensor:
    """Differentiable cross-map LRN over NCHW ``x``.  Without a gradient
    to take it is one forward launch that writes no ``den``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CrossMapLRN.apply(x, size, alpha, beta, k)
    return cross_map_lrn_forward(x, size, alpha, beta, k)

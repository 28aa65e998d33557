"""Local response normalization: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd functions that join them (the
port of ``bigdl_tpu/ops/lrn_pallas.py``).

Cross-map (``cross_map_lrn``, Pallas kernels ``_cml_fwd_kernel`` and
``_cml_bwd_kernel``):

    den = k + (alpha / n) * sum_{band} x^2     (zero channel halo)
    y   = x * den^-beta                       (rsqrt when beta == 0.5)
    t   = g * x * den^(-beta-1)               (zero channel halo)
    dx  = g * den^-beta - (2 alpha beta / n) * x * sum_{band} t

Both band sums run over the padded channel window in order
d = 0 .. n-1, the order of the Pallas kernels; for an odd band the
transposed window of the backward is the forward's.

Within-channel (``within_channel_lrn``, Pallas kernels
``_wcl_fwd_kernel`` and ``_wcl_bwd_kernel``), over an n x n spatial
window with Torch pads ``(lo, hi) = ((n-1)//2, n-1-lo)``:

    scale = 1 + (alpha / n^2) * win(x^2)      (zero spatial halo)
    y     = x * scale^-beta
    t     = g * x * scale^(-beta-1)
    dx    = g * scale^-beta - (2 alpha beta / n^2) * x * win^T(t)

where ``win^T`` is the window under the swapped pads ``(hi, lo)``, exact
for even windows too.  Both window sums run over the taps in (dh, dw)
order, the order of the Pallas kernels.

Routing mirrors the JAX package minus its TPU-only conditions (VMEM
budget, Mosaic dtypes).  Cross-map: 4-D input with an odd band goes to
the kernel on a CUDA tensor and to the plain version on a CPU tensor;
anything else structural (other ranks, even bands) runs the plain
version on every device, as the JAX package runs its XLA leg there.
Within-channel: the op takes 4-D input and ``size >= 1`` (its layer
sends other ranks to its own window-mean branch) and raises on anything
else.  A CUDA tensor the kernel cannot take (dtype, layout, window wider
than the kernel's tile) raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["cross_map_lrn", "cross_map_lrn_forward", "cross_map_lrn_plain",
           "cross_map_lrn_backward", "cross_map_lrn_backward_plain",
           "within_channel_lrn", "within_channel_lrn_forward",
           "within_channel_lrn_plain", "within_channel_lrn_backward",
           "within_channel_lrn_backward_plain", "KERNEL_DTYPES",
           "MAX_KERNEL_SIZE", "MAX_WINDOW"]

#: dtypes the kernel reads and writes (its math is f32)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest band the kernel is instantiated for (odd sizes 1..15)
MAX_KERNEL_SIZE = 15
#: widest within-channel window the kernels' shared-memory tile takes
MAX_WINDOW = 32


def _f32(a: torch.Tensor) -> torch.Tensor:
    """16-bit tensors in f32, the kernels' math; f32 as it is."""
    return a.float() if a.dtype in (torch.bfloat16, torch.float16) else a


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
    xf = _f32(x)
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


def _check_kernel_args(what: str, size: int, max_size: int,
                       *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: one dtype of ``KERNEL_DTYPES``, shape
    and device across ``tensors``, contiguous, a window up to
    ``max_size``."""
    x = tensors[0]
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    if any(t.dtype != x.dtype or t.shape != x.shape or t.device != x.device
           for t in tensors):
        raise ValueError(f"{what} kernel takes tensors of one dtype, shape "
                         f"and device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if size > max_size:
        raise ValueError(f"{what} kernel is built for windows up to "
                         f"{max_size}, got {size}")


def _launch(x: torch.Tensor, size: int, alpha: float, beta: float,
            k: float, want_den: bool):
    from bigdl_tpu_torch.ops import _build

    _check_kernel_args("cross-map LRN", size, MAX_KERNEL_SIZE, x)
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
    xf, df, gf = _f32(x), _f32(den), _f32(g)
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

    _check_kernel_args("cross-map LRN", size, MAX_KERNEL_SIZE, x, den, g)
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


# ---------------------------------------------------------------------------
# within-channel LRN: an n x n window over each plane
# ---------------------------------------------------------------------------

def _window_pads(size: int) -> Tuple[int, int]:
    lo = (size - 1) // 2
    return lo, size - 1 - lo


def _window_sum(v: torch.Tensor, size: int, pads: Tuple[int, int]
                ) -> torch.Tensor:
    """Sum of ``v`` over a size x size window of its last two axes, zero
    outside, one tap at a time in (dh, dw) order (``_wcl_*_kernel``)."""
    h, w = v.shape[-2:]
    vp = F.pad(v, (pads[0], pads[1], pads[0], pads[1]))
    s = None
    for dh in range(size):
        for dw in range(size):
            tap = vp[..., dh:dh + h, dw:dw + w]
            s = tap if s is None else s + tap
    return s


def _check_within_channel(x: torch.Tensor, size: int) -> None:
    """The op's structural gate (``within_channel_lrn_supported`` minus
    its TPU-only checks): 4-D NCHW and ``size >= 1``, on every device."""
    if x.ndim != 4 or size < 1:
        raise ValueError(f"within-channel LRN takes 4-D NCHW input and a "
                         f"window of at least 1, got {tuple(x.shape)} and "
                         f"{size}")


def within_channel_lrn_plain(x: torch.Tensor, size: int, alpha: float,
                             beta: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, scale) over NCHW ``x`` on any device (``_wcl_fwd_kernel``);
    16-bit inputs compute in f32 and round both to x's dtype, as the
    kernel does."""
    xf = _f32(x)
    ws = _window_sum(xf * xf, size, _window_pads(size))
    scale = 1.0 + ws * (alpha / (size * size))
    y = xf * _pow(scale, -beta)
    return y.to(x.dtype), scale.to(x.dtype)


def within_channel_lrn_forward(x: torch.Tensor, size: int, alpha: float,
                               beta: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, scale) of within-channel LRN over NCHW ``x``; ``scale`` is in
    x's dtype, as the Pallas kernel writes it.  A CUDA tensor launches
    the kernel (``csrc/wcl_fwd.cu``) or raises; a CPU tensor runs
    :func:`within_channel_lrn_plain`."""
    _check_within_channel(x, size)
    if x.device.type == "cpu":
        return within_channel_lrn_plain(x, size, alpha, beta)
    if x.device.type != "cuda":
        raise RuntimeError(f"no within-channel LRN kernel for device "
                           f"{x.device}")
    from bigdl_tpu_torch.ops import _build

    _check_kernel_args("within-channel LRN", size, MAX_WINDOW, x)
    n, c, h, w = x.shape
    y, scale = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return y, scale
    lib = _build.library("wcl_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_wcl_fwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(scale.data_ptr()), n * c, h, w, size,
            _window_pads(size)[0], float(alpha / (size * size)),
            float(-beta), KERNEL_DTYPES[x.dtype], ctypes.c_void_p(stream))
    _build.check(lib, err, "within-channel LRN forward")
    within_channel_lrn_forward.launches += 1
    return y, scale


#: kernel launches made by this wrapper (and nowhere else)
within_channel_lrn_forward.launches = 0


def within_channel_lrn_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                                      g: torch.Tensor, size: int,
                                      alpha: float, beta: float
                                      ) -> torch.Tensor:
    """dx over NCHW ``x`` from the forward's ``scale`` and the output
    gradient ``g``, on any device (``_wcl_bwd_pallas``); 16-bit inputs
    compute in f32 and round dx to x's dtype, as the kernel does."""
    xf, sf, gf = _f32(x), _f32(scale), _f32(g)
    lo, hi = _window_pads(size)
    t = gf * xf * _pow(sf, -beta - 1.0)
    ts = _window_sum(t, size, (hi, lo))
    dx = gf * _pow(sf, -beta) \
        - (2.0 * alpha * beta / (size * size)) * xf * ts
    return dx.to(x.dtype)


def within_channel_lrn_backward(x: torch.Tensor, scale: torch.Tensor,
                                g: torch.Tensor, size: int, alpha: float,
                                beta: float) -> torch.Tensor:
    """dx of within-channel LRN.  A CUDA tensor launches the kernel
    (``csrc/wcl_bwd.cu``) or raises; a CPU tensor runs
    :func:`within_channel_lrn_backward_plain`."""
    _check_within_channel(x, size)
    if x.device.type == "cpu":
        return within_channel_lrn_backward_plain(x, scale, g, size, alpha,
                                                 beta)
    if x.device.type != "cuda":
        raise RuntimeError(f"no within-channel LRN kernel for device "
                           f"{x.device}")
    from bigdl_tpu_torch.ops import _build

    _check_kernel_args("within-channel LRN", size, MAX_WINDOW, x, scale, g)
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    lib = _build.library("wcl_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bigdl_wcl_bwd(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
            n * c, h, w, size, _window_pads(size)[1],
            float(2.0 * alpha * beta / (size * size)), float(-beta),
            float(-beta - 1.0), KERNEL_DTYPES[x.dtype],
            ctypes.c_void_p(stream))
    _build.check(lib, err, "within-channel LRN backward")
    within_channel_lrn_backward.launches += 1
    return dx


#: kernel launches made by this wrapper (and nowhere else)
within_channel_lrn_backward.launches = 0


class _WithinChannelLRN(torch.autograd.Function):
    """Forward keeps ``(x, scale)``; backward is the kernel (the JAX
    ``custom_vjp``, ``lrn_pallas.py:387-400``)."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta):
        y, scale = within_channel_lrn_forward(x, size, alpha, beta)
        ctx.save_for_backward(x, scale)
        ctx.hyper = (size, alpha, beta)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx = within_channel_lrn_backward(x, scale, g.contiguous(),
                                         *ctx.hyper)
        return dx, None, None, None


def within_channel_lrn(x: torch.Tensor, size: int, alpha: float,
                       beta: float) -> torch.Tensor:
    """Differentiable within-channel LRN over NCHW ``x``: one forward
    launch, and one backward launch when a gradient is taken."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _WithinChannelLRN.apply(x, size, alpha, beta)
    return within_channel_lrn_forward(x, size, alpha, beta)[0]

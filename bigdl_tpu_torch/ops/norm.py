"""Subtractive, divisive and contrastive normalization: the smoothing
kernel's wrapper, its plain PyTorch version, and the autograd functions
built on it (the port of ``bigdl_tpu/ops/norm_pallas.py``, Pallas kernel
``_smooth_kernel``).

All three are built around ``sm``, a kernel-weighted window sum over a
``[B, H, W]`` stack of planes (:func:`smooth2d`), with ``coef = sm(1)``
the kernel mass inside the image at each position:

- subtractive: ``y = x - sm(mean_c(x)) / coef``;
  ``dx = g - sm^T(sum_c(g) / coef) / C``;
- divisive: ``y = x / d``, ``d = thresh(max(sigma, mean_hw(sigma)))``,
  ``sigma = sqrt(clip(sm(mean_c(x^2)) / coef, 0))``; the backward
  chains the pieces term by term as ``_div_vjp_bwd`` does, ties of
  ``sigma`` and its mean going to the position branch and ``sigma == 0``
  to a zero gradient;
- contrastive: divisive(subtractive(x)).

``sm^T`` is the smoothing with the flipped kernel under swapped pads.
Every smoothing call goes through :func:`smooth2d`, so a forward and
backward launch the kernel as often as the JAX op dispatches its Pallas
leg: subtractive and divisive twice forward (``coef`` and the map) and
once backward, contrastive twice that.  ``coef`` is not cached across
calls, as the JAX package does not cache it.  The smoothing kernel is a
buffer: its gradient is zero.

Routing: :func:`smooth2d` takes a ``[B, H, W]`` stack and a 2-D kernel
on every device (``smooth2d_supported`` minus its TPU-only checks) and
raises on anything else.  A CUDA stack launches the kernel
(``csrc/smooth2d.cu``) or raises; a CPU stack runs
:func:`smooth2d_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops.lrn import (KERNEL_DTYPES, MAX_WINDOW,
                                     _check_kernel_args, _f32)

__all__ = ["smooth2d", "smooth2d_plain", "subtractive_norm",
           "divisive_norm", "contrastive_norm"]

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _fwd_pads(kh: int, kw: int) -> Pads:
    return (kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)


def _transpose_pads(kh: int, kw: int) -> Pads:
    (alo, ahi), (blo, bhi) = _fwd_pads(kh, kw)
    return (ahi, alo), (bhi, blo)


def _check_smooth(stack: torch.Tensor, kernel: torch.Tensor) -> None:
    if stack.ndim != 3 or kernel.ndim != 2:
        raise ValueError(f"smooth2d takes a [B, H, W] stack and a 2-D "
                         f"kernel, got {tuple(stack.shape)} and "
                         f"{tuple(kernel.shape)}")


def _weights(kernel: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """The kernel rounded to the stack's dtype, as the Pallas leg casts
    it, then held in f32 on the stack's device."""
    return kernel.to(device=stack.device, dtype=stack.dtype).float()


def smooth2d_plain(stack: torch.Tensor, kernel: torch.Tensor, pads: Pads,
                   flip: bool = False) -> torch.Tensor:
    """Kernel-weighted window sum over a [B, H, W] stack on any device,
    tap by tap in (i, j) order (``_smooth_kernel``); 16-bit stacks
    compute in f32 and round the result to their dtype, as the kernel
    does."""
    _check_smooth(stack, kernel)
    wk = _weights(kernel, stack)
    if flip:
        wk = wk.flip(0, 1)
    kh, kw = wk.shape
    (alo, ahi), (blo, bhi) = pads
    vp = F.pad(_f32(stack), (blo, bhi, alo, ahi))
    h, w = vp.shape[1] - kh + 1, vp.shape[2] - kw + 1
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = vp[:, i:i + h, j:j + w] * wk[i, j]
            acc = tap if acc is None else acc + tap
    return acc.to(stack.dtype)


def smooth2d(stack: torch.Tensor, kernel: torch.Tensor, pads: Pads,
             flip: bool = False) -> torch.Tensor:
    """Kernel-weighted window sum over a [B, H, W] stack; ``flip=True``
    with swapped pads is the transpose.  A CUDA stack launches the
    kernel (``csrc/smooth2d.cu``: tiles of up to 32 x 32 outputs staged
    in f32 shared memory, each thread summing 4 outputs of a row from
    registers, two rows at once for the normalizations' 9 x 9 window,
    which is compiled in; bit-equal to :func:`smooth2d_plain`) or
    raises; a CPU stack runs :func:`smooth2d_plain`.  Not
    differentiable on its own: the autograd functions below call it in
    their forwards and backwards."""
    _check_smooth(stack, kernel)
    if stack.device.type == "cpu":
        return smooth2d_plain(stack, kernel, pads, flip)
    if stack.device.type != "cuda":
        raise RuntimeError(f"no smoothing kernel for device {stack.device}")
    from bigdl_tpu_torch.ops import _build

    kh, kw = kernel.shape
    _check_kernel_args("smoothing", max(kh, kw), MAX_WINDOW, stack)
    (alo, ahi), (blo, bhi) = pads
    b, h, w = stack.shape
    out_h, out_w = h + alo + ahi - kh + 1, w + blo + bhi - kw + 1
    if min(alo, ahi, blo, bhi) < 0 or out_h < 0 or out_w < 0:
        raise ValueError(f"smoothing kernel takes non-negative pads that "
                         f"leave an output, got {pads}")
    out = stack.new_empty((b, out_h, out_w))
    if out.numel() == 0:
        return out
    wt = _weights(kernel, stack).contiguous()
    lib = _build.library("smooth2d")
    with torch.cuda.device(stack.device):
        s = torch.cuda.current_stream(stack.device).cuda_stream
        err = lib.bigdl_smooth2d(
            ctypes.c_void_p(stack.data_ptr()), ctypes.c_void_p(wt.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), b, h, w, out_h, out_w, kh, kw,
            alo, blo, int(flip), KERNEL_DTYPES[stack.dtype],
            ctypes.c_void_p(s))
    _build.check(lib, err, "smoothing")
    smooth2d.launches += 1
    return out


#: kernel launches made by this wrapper (and nowhere else)
smooth2d.launches = 0


def _coef(kernel: torch.Tensor, h: int, w: int, like: torch.Tensor
          ) -> torch.Tensor:
    """Edge-coverage mass ``sm(1)``: the kernel weight inside the image
    at each position, [1, H, W] in ``like``'s dtype and device."""
    ones = torch.ones((1, h, w), dtype=like.dtype, device=like.device)
    return smooth2d(ones, kernel, _fwd_pads(*kernel.shape))


def _kernel_grad(ctx, kernel: torch.Tensor):
    """The smoothing kernel is a buffer: zero gradient when asked."""
    return torch.zeros_like(kernel) if ctx.needs_input_grad[1] else None


class _Subtractive(torch.autograd.Function):
    """``subtractive_norm`` with its exact backward (``_sub_vjp_fwd``,
    ``_sub_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, kernel):
        h, w = x.shape[2:]
        coef = _coef(kernel, h, w, x)
        m = smooth2d(x.mean(dim=1), kernel, _fwd_pads(*kernel.shape)) / coef
        ctx.save_for_backward(kernel, coef)
        ctx.c = x.shape[1]
        return x - m[:, None]

    @staticmethod
    def backward(ctx, g):
        kernel, coef = ctx.saved_tensors
        v = g.sum(dim=1) / coef
        corr_t = smooth2d(v.contiguous(), kernel,
                          _transpose_pads(*kernel.shape), flip=True)
        return g - corr_t[:, None] / ctx.c, _kernel_grad(ctx, kernel)


class _Divisive(torch.autograd.Function):
    """``divisive_norm`` with its exact backward (``_div_vjp_fwd``,
    ``_div_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, kernel, threshold, thresval):
        h, w = x.shape[2:]
        usq = (x * x).mean(dim=1)
        coef = _coef(kernel, h, w, x)
        s = smooth2d(usq, kernel, _fwd_pads(*kernel.shape)) / coef
        sigma = torch.sqrt(torch.clamp(s, min=0.0))
        mu = sigma.mean(dim=(1, 2), keepdim=True)
        e = torch.maximum(sigma, mu)
        d = torch.where(e < threshold,
                        torch.full((), thresval, dtype=x.dtype,
                                   device=x.device), e)
        ctx.save_for_backward(x, kernel, sigma, mu, d, coef)
        ctx.threshold = threshold
        return x / d[:, None]

    @staticmethod
    def backward(ctx, g):
        x, kernel, sigma, mu, d, coef = ctx.saved_tensors
        c = x.shape[1]
        hw = sigma.shape[1] * sigma.shape[2]
        gd = -(g * x).sum(dim=1) / (d * d)
        e = torch.maximum(sigma, mu)
        ge = torch.where(e >= ctx.threshold, gd, 0.0)
        mask_sig = sigma >= mu              # ties -> position branch
        gmu = torch.where(mask_sig, 0.0, ge).sum(dim=(1, 2), keepdim=True)
        gsig = torch.where(mask_sig, ge, 0.0) + gmu / hw
        gs = torch.where(sigma > 0, gsig / (2.0 * sigma), 0.0)
        gusq = smooth2d((gs / coef).contiguous(), kernel,
                        _transpose_pads(*kernel.shape), flip=True)
        dx = g / d[:, None] + x * (2.0 / c) * gusq[:, None]
        return dx, _kernel_grad(ctx, kernel), None, None


def subtractive_norm(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x`` minus its kernel-weighted local mean over NCHW, with the
    exact backward; ``kernel`` gets a zero gradient."""
    return _Subtractive.apply(x, kernel)


def divisive_norm(x: torch.Tensor, kernel: torch.Tensor,
                  threshold: float = 1e-4, thresval: float = 1e-4
                  ) -> torch.Tensor:
    """``x`` over its thresholded local standard deviation over NCHW,
    with the exact backward; ``kernel`` gets a zero gradient."""
    return _Divisive.apply(x, kernel, threshold, thresval)


def contrastive_norm(x: torch.Tensor, kernel: torch.Tensor,
                     threshold: float = 1e-4, thresval: float = 1e-4
                     ) -> torch.Tensor:
    """Subtractive then divisive normalization: the two exact backwards
    compose into the exact backward of the whole."""
    return divisive_norm(subtractive_norm(x, kernel), kernel, threshold,
                         thresval)

"""Cross-map LRN forward: the CUDA kernel's wrapper and its plain
PyTorch version (the port of ``bigdl_tpu/ops/lrn_pallas.py``
``cross_map_lrn`` forward, Pallas kernel ``_cml_fwd_kernel``).

    den = k + (alpha / n) * sum_{band} x^2     (zero channel halo)
    y   = x * den^-beta                       (rsqrt when beta == 0.5)

The band sum runs over the padded channel window in order
d = 0 .. n-1, the order of the Pallas kernel.

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

__all__ = ["cross_map_lrn_forward", "cross_map_lrn_plain", "KERNEL_DTYPES",
           "MAX_KERNEL_SIZE"]

#: dtypes the kernel reads and writes (its math is f32)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest band the kernel is instantiated for (odd sizes 1..15)
MAX_KERNEL_SIZE = 15


def _neg_pow(den: torch.Tensor, beta: float) -> torch.Tensor:
    """den ** -beta for den > 0, as ``lrn_pallas._pow`` computes it."""
    if beta == 0.5:
        return torch.rsqrt(den)
    return torch.exp(-beta * torch.log(den))


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
    y = xf * _neg_pow(den, beta)
    return y.to(x.dtype), den.to(x.dtype)


def _kernel_supported(x: torch.Tensor, size: int) -> bool:
    """Structural gate, the JAX ``cross_map_lrn_supported`` minus its
    TPU-only checks: 4-D NCHW, odd band."""
    return x.ndim == 4 and size >= 1 and size % 2 == 1


def _launch(x: torch.Tensor, size: int, alpha: float, beta: float,
            k: float, want_den: bool):
    from bigdl_tpu_torch.ops import _build

    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"cross-map LRN kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("cross-map LRN kernel takes a contiguous NCHW tensor")
    if size > MAX_KERNEL_SIZE:
        raise ValueError(f"cross-map LRN kernel is built for odd bands up "
                         f"to {MAX_KERNEL_SIZE}, got {size}")
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

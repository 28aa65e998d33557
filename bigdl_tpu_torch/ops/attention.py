"""Scaled dot-product attention: the dense version, the flash kernels'
wrappers with their plain PyTorch versions, and the autograd function
that joins them (the port of ``bigdl_tpu/ops/attention.py``: Pallas
kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` under the
``jax.custom_vjp`` ``_flash``).

Shapes are [batch, heads, seq, head_dim] throughout, as in JAX.

    s    = q k^T * scale, masked entries -1e30 (causal: q row i sees the
           keys up to i + sk - sq)
    p    = where(s > -1e30/2, exp(s - lse), 0)
    out  = p v,                       lse = m + log(l)   (forward)
    ds   = p * (do v^T - delta) * scale,   delta = sum(do * out, -1)
    dq   = ds k,   dk = ds^T q,   dv = p^T do           (backward)

A row with no key to attend (``l == 0``) gets ``out = 0`` and
``lse = -1e30``.  The flash kernels (``csrc/flash_fwd.cu``,
``flash_dq.cu``, ``flash_dkv.cu``) take f32 and bf16, chosen by dtype
inside each library: in bf16 all three run on the tensor cores
(``mma.sync`` bf16 products with f32 accumulators; ``p`` and ``ds`` are
rounded to bf16 before their second product, ``p v``, ``ds k``,
``ds^T q`` and ``p^T do``, where the Pallas kernels keep them in f32: a
relative error of at most 2^-9 a term), while in f32 all three compute
in f32 on the CUDA cores.  They pick their own tiles, mask the ragged
last tile themselves and take head dims up to 128.  A CUDA tensor
launches them or raises; a CPU tensor runs the plain versions.  The
TPU-only pieces are not carried over: the Pallas block sizes and their
environment overrides, the Mosaic-tiling dense fallback, and the
``BIGDL_KERNELS`` and ``BIGDL_FLASH_MIN_SEQ`` switches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

__all__ = ["dot_product_attention", "flash_attention", "flash_min_seq",
           "select_attention_backend", "flash_fwd", "flash_dq",
           "flash_dkv", "flash_fwd_plain", "flash_bwd_plain",
           "KERNEL_DTYPES", "MAX_HEAD_DIM"]

NEG_INF = -1e30
#: dtypes the kernels read and write: f32 computes in f32 on the CUDA
#: cores, bf16 on the tensor cores
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim the kernels take
MAX_HEAD_DIM = 128
#: sequence length from which ``backend='auto'`` takes the flash kernels
#: on the card: the JAX package's default, kept until it is re-picked
#: from H100 step times
FLASH_MIN_SEQ = 512


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] True where q row i may see key j: i + (sk - sq) >= j."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return q_pos >= torch.arange(sk, device=device)[None, :]


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          scale: Optional[float] = None):
    """Dense softmax(q k^T * scale) v.  ``mask`` broadcasts to
    [B, H, Sq, Sk], True = attend.  Scores are summed and normalised in
    f32; a row with every key masked outputs 0."""
    scale = _scale(q, scale)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_keep(s.shape[-2], s.shape[-1], s.device),
                        s, NEG_INF)
    if mask is not None:
        s = torch.where(torch.as_tensor(mask, device=s.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    valid = s.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(valid, p, 0.0)
    return torch.matmul(p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def flash_min_seq() -> int:
    """Sequence length at which ``backend='auto'`` switches from dense to
    flash attention on the card."""
    return FLASH_MIN_SEQ


def select_attention_backend(sq: int, sk: int, masked: bool = False,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Tuple[str, str]:
    """THE auto-backend rule, (backend, reason), in the JAX package's
    order: ``sq == 1`` (the decode shape) -> dense; a mask -> dense (the
    kernels take none beyond ``causal``); off the card -> dense, as JAX
    routes off-TPU; then flash from ``flash_min_seq()`` up, judged on
    both lengths."""
    if sq == 1:
        return "dense", "decode:q_len=1"
    if masked:
        return "dense", "masked"
    if torch.device(device).type != "cuda":
        return "dense", "auto:off-cuda"
    if max(sq, sk) < flash_min_seq():
        return "dense", "auto:below-min-seq"
    return "flash", "auto:cuda"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, scale, causal, ct):
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_keep(q.shape[2], k.shape[2], s.device),
                        s, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, scale: float, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes, on any device, in f32 (f64
    inputs stay f64): ``(out, lse)``, ``out`` in q's dtype and ``lse``
    [B, H, Sq] in f32."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = _scores(q, k, scale, causal, ct)
    m = s.amax(dim=-1)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p, v.to(ct)) / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.to(q.dtype), lse.to(torch.promote_types(ct, torch.float32))


def _bwd_plain_parts(q, k, v, lse, do, delta, scale, causal):
    ct = torch.promote_types(q.dtype, torch.float32)
    s = _scores(q, k, scale, causal, ct)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - lse.to(ct)[..., None]),
                    0.0)
    dof = do.to(ct)
    dp = torch.matmul(dof, v.to(ct).transpose(-1, -2))
    ds = p * (dp - delta.to(ct)[..., None]) * scale
    return ct, p, ds, dof


def _dq_plain(q, k, v, lse, do, delta, scale, causal):
    ct, _, ds, _ = _bwd_plain_parts(q, k, v, lse, do, delta, scale, causal)
    return torch.matmul(ds, k.to(ct)).to(q.dtype)


def _dkv_plain(q, k, v, lse, do, delta, scale, causal):
    ct, p, ds, dof = _bwd_plain_parts(q, k, v, lse, do, delta, scale,
                                      causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(ct))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, out, lse, do, delta, scale: float,
                    causal: bool):
    """What the dq and dkv kernels compute, on any device, in f32 (f64
    inputs stay f64): ``(dq, dk, dv)`` in the inputs' dtypes.  ``p`` is
    recomputed from ``lse``; ``delta`` is ``sum(do * out, -1)``."""
    del out  # enters through delta, as in the kernels
    return ((_dq_plain(q, k, v, lse, do, delta, scale, causal),)
            + _dkv_plain(q, k, v, lse, do, delta, scale, causal))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version
    (a CPU tensor); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no {what} kernel for device {x.device}")
    return True


def _check(what: str, q, k, v, **extra) -> Tuple[int, int, int, int, int]:
    """Device, dtype, contiguity and shape checks of one launch; returns
    (b, h, sq, sk, d)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, H, S, D] of one "
                         f"B, H and D")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d > MAX_HEAD_DIM or min(b, h, sq, sk, d) < 1:
        raise ValueError(f"{what}: takes [B, H, S, D] with every extent at "
                         f"least 1 and D at most {MAX_HEAD_DIM}, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes one dtype of "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    tensors = dict(q=q, k=k, v=v, **extra)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors; "
                             f"{name} is not")
    for name in ("lse", "delta"):
        t = extra.get(name)
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (b, h, sq)):
            raise ValueError(f"{what}: {name} must be f32 [{b}, {h}, {sq}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    do = extra.get("do")
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise ValueError(f"{what}: do {do.dtype} {tuple(do.shape)} does not "
                         f"match q {q.dtype} {tuple(q.shape)}")
    return b, h, sq, sk, d


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_fwd(q, k, v, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of flash attention.  A CUDA tensor launches the
    kernel (``csrc/flash_fwd.cu``: bf16 always on the tensor-core
    kernel, f32 on the CUDA-core one, for every head dim 1-128) or
    raises; a CPU tensor runs :func:`flash_fwd_plain`.  ``launches``
    counts every kernel launch, so a bf16 path's count is the
    tensor-core kernel's."""
    if not _route(q, "flash-attention forward"):
        return flash_fwd_plain(q, k, v, scale, causal)
    from bigdl_tpu_torch.ops import _build

    b, h, sq, sk, d = _check("flash-attention forward", q, k, v)
    lib = _build.library("flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.bigdl_flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b * h, sq, sk,
            d, float(scale), int(bool(causal)), KERNEL_DTYPES[q.dtype],
            _stream(q.device))
    _build.check(lib, err, "flash-attention forward")
    flash_fwd.launches += 1
    return out, lse


#: kernel launches made by this wrapper (and nowhere else)
flash_fwd.launches = 0


def flash_dq(q, k, v, do, lse, delta, scale: float, causal: bool
             ) -> torch.Tensor:
    """dq of flash attention.  A CUDA tensor launches the kernel
    (``csrc/flash_dq.cu``: bf16 always on the tensor-core kernel, f32 on
    the CUDA-core one, for every head dim 1-128) or raises; a CPU tensor
    runs the plain version.  ``launches`` counts every kernel launch, so
    a bf16 path's count is the tensor-core kernel's."""
    if not _route(q, "flash-attention dq"):
        return _dq_plain(q, k, v, lse, do, delta, scale, causal)
    from bigdl_tpu_torch.ops import _build

    b, h, sq, sk, d = _check("flash-attention dq", q, k, v, do=do, lse=lse,
                             delta=delta)
    lib = _build.library("flash_dq")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.bigdl_flash_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), b * h, sq, sk, d, float(scale), int(bool(causal)),
            KERNEL_DTYPES[q.dtype], _stream(q.device))
    _build.check(lib, err, "flash-attention dq")
    flash_dq.launches += 1
    return dq


#: kernel launches made by this wrapper (and nowhere else)
flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of flash attention.  A CUDA tensor launches the
    kernel (``csrc/flash_dkv.cu``: bf16 always on the tensor-core
    kernel, f32 on the CUDA-core one, for every head dim 1-128) or
    raises; a CPU tensor runs the plain version.  ``launches`` counts
    every kernel launch, so a bf16 path's count is the tensor-core
    kernel's."""
    if not _route(q, "flash-attention dkv"):
        return _dkv_plain(q, k, v, lse, do, delta, scale, causal)
    from bigdl_tpu_torch.ops import _build

    b, h, sq, sk, d = _check("flash-attention dkv", q, k, v, do=do, lse=lse,
                             delta=delta)
    lib = _build.library("flash_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.bigdl_flash_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dk), _ptr(dv), b * h, sq, sk, d, float(scale),
            int(bool(causal)), KERNEL_DTYPES[q.dtype], _stream(q.device))
    _build.check(lib, err, "flash-attention dkv")
    flash_dkv.launches += 1
    return dk, dv


#: kernel launches made by this wrapper (and nowhere else)
flash_dkv.launches = 0


class _Flash(torch.autograd.Function):
    """The forward saves ``q, k, v, out, lse`` (``_flash_fwd_rule``); the
    backward forms ``delta`` in f32 outside the kernels, as
    ``_flash_bwd_impl`` does, then launches dq and dkv."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        ct = torch.promote_types(q.dtype, torch.float32)
        delta = (do.to(ct) * out.to(ct)).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention, [B, H, S, D] in and out, differentiable.  The
    score matrix never reaches device memory: the forward keeps ``lse``
    and the backward recomputes ``p`` from it."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, _scale(q, scale), bool(causal))

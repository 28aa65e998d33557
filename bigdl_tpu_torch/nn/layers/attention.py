"""LayerNorm, MultiHeadAttention and TransformerBlock, ported from
``bigdl_tpu/nn/layers/attention.py``.

The attention core routes to ``bigdl_tpu_torch.ops.attention``: the dense
version, or the flash kernels behind their autograd function.  Not
ported yet: the generation cache hooks (decode) and the
sequence-parallel callables.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.layers.normalization import Dropout
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops import attention as ops

__all__ = ["LayerNorm", "MultiHeadAttention", "TransformerBlock"]


class LayerNorm(Module):
    """Layer normalization over the last dimension: population variance,
    ``(x - mean) / sqrt(var + eps)``, then ``* weight + bias``."""

    def __init__(self, normalized_size: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.normalized_size = normalized_size
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(normalized_size))
            self.bias = torch.nn.Parameter(torch.zeros(normalized_size))

    def forward(self, x):
        w = self.weight.to(x.dtype) if self.affine else None
        b = self.bias.to(x.dtype) if self.affine else None
        return F.layer_norm(x, (self.normalized_size,), w, b, self.eps)


class MultiHeadAttention(Module):
    """Multi-head attention over [batch, seq, embed] inputs.

    ``backend``: ``"auto"`` (:func:`ops.attention.select_attention_backend`:
    on the card flash from ``flash_min_seq()`` up, dense below it and on
    the CPU), ``"dense"``, ``"flash"``, or a callable ``f(q, k, v) ->
    out`` over [B, H, S, D] with causal and scale baked in.  Callables
    and ``"flash"`` take no mask.  ``dropout`` drops the context before
    the output projection in training mode.

    Input: one tensor (self-attention), ``(x, mask)``, ``(query, key,
    value)`` or ``(query, key, value, mask)``; tensors are [B, S, E] and
    the mask broadcasts to [B, H, Sq, Sk] (True = attend).  For
    self-attention the three projections run as ONE product with the
    concatenated [3E, E] weight; the gradients flow back to the separate
    ``q/k/v_proj`` parameters, so the state keys do not change."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 with_bias: bool = True, causal: bool = False,
                 backend="auto", generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.dropout_p = dropout
        self.backend = backend
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(embed_dim, embed_dim,
                                       with_bias=with_bias,
                                       generator=generator))
        if dropout > 0.0:
            self.drop = Dropout(dropout)

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _attend(self, q, k, v, mask):
        backend = self.backend
        if callable(backend):
            if mask is not None:
                raise ValueError("custom attention backends do not accept "
                                 "masks; bake masking into the callable")
            return backend(q, k, v)
        if backend == "flash" and mask is not None:
            raise ValueError("backend='flash' does not support masks (only "
                             "causal=True); use backend='dense' or 'auto' for "
                             "masked attention")
        if backend == "auto":
            backend, _ = ops.select_attention_backend(
                q.shape[2], k.shape[2], mask is not None, q.device)
        if backend == "flash":
            return ops.flash_attention(q, k, v, causal=self.causal)
        if backend != "dense":
            raise ValueError(f"unknown attention backend {backend!r}")
        return ops.dot_product_attention(q, k, v, mask=mask,
                                         causal=self.causal)

    def forward(self, input):
        mask = None
        if isinstance(input, (tuple, list)):
            if len(input) == 2:
                x, mask = input
                xq = xk = xv = x
            elif len(input) == 3:
                xq, xk, xv = input
            elif len(input) == 4:
                xq, xk, xv, mask = input
            else:
                raise ValueError("input must be x, (x, mask), (q, k, v) or "
                                 "(q, k, v, mask)")
        else:
            xq = xk = xv = input
        if xq is xk and xk is xv:
            w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight]).to(xq.dtype)
            b = None
            if self.q_proj.with_bias:
                b = torch.cat([self.q_proj.bias, self.k_proj.bias,
                               self.v_proj.bias]).to(xq.dtype)
            q, k, v = (self._split(t)
                       for t in F.linear(xq, w, b).chunk(3, dim=-1))
        else:
            q = self._split(self.q_proj(xq))
            k = self._split(self.k_proj(xk))
            v = self._split(self.v_proj(xv))
        out = self._attend(q, k, v, mask)
        b, h, s, d = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * d)
        if self.dropout_p > 0.0:
            out = self.drop(out)
        return self.out_proj(out)


class TransformerBlock(Module):
    """Pre-norm block: LN -> attention -> residual, LN -> MLP (GELU, tanh
    approximation, as ``jax.nn.gelu`` defaults) -> residual."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, causal: bool = True, backend="auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim)
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout=dropout,
                                       causal=causal, backend=backend,
                                       generator=generator)
        self.ln2 = LayerNorm(embed_dim)
        self.fc1 = Linear(embed_dim, embed_dim * mlp_ratio,
                          generator=generator)
        self.fc2 = Linear(embed_dim * mlp_ratio, embed_dim,
                          generator=generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)

"""LookupTable, ported from ``bigdl_tpu/nn/layers/embedding.py`` (the
dense path).

Not ported yet: the row-sparse gradient capture, ``EmbeddingBag``,
``sparse=True`` (``sparse`` is accepted only as None or False) and the
weight regularizer; the JAX arguments the port does not act on are not
accepted, and the others are keyword-only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init import RandomNormal
from bigdl_tpu_torch.nn.module import Module

__all__ = ["LookupTable"]


class LookupTable(Module):
    """Embedding lookup (``nn/LookupTable.scala``): ``weight[input]`` for
    integer (or float, truncated) indices of any shape, 0-based unless
    ``one_based``.  ``padding_idx``: that row gets no gradient, but its
    value is still gathered.  ``max_norm`` renormalises the rows it
    gathers (``norm_type`` norm), and the gradient flows through the
    renorm.  The weight is drawn from N(0, 1).

    Out-of-range indices gather what the JAX package's ``w[idx]``
    gathers: a negative index counts from the end (-1 is the last row),
    and whatever still lies outside ``[0, n_index)`` is clamped to the
    nearest row (past the end: the last row; below ``-n_index``: row 0).
    The rule is applied to the index with tensor ops before the gather,
    so no index reaches ``F.embedding`` out of range and no device-side
    assert can fire on the card."""

    def __init__(self, n_index: int, n_output: int, *,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 one_based: bool = False, padding_idx: Optional[int] = None,
                 sparse: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if sparse not in (None, False):
            raise NotImplementedError(
                "LookupTable(sparse=...) is not ported yet: the port's "
                "tables are dense")
        self.n_index, self.n_output = n_index, n_output
        self.max_norm, self.norm_type = max_norm, norm_type
        self.one_based = one_based
        self.padding_idx = padding_idx
        self.weight = torch.nn.Parameter(RandomNormal(0.0, 1.0).init(
            (n_index, n_output), generator=generator))

    def _indices(self, x) -> torch.Tensor:
        idx = torch.as_tensor(x, device=self.weight.device)
        if idx.is_floating_point():
            idx = idx.to(torch.int32)
        idx = idx.long()
        return idx - 1 if self.one_based else idx

    def forward(self, x):
        idx = self._indices(x)
        n = self.weight.shape[0]
        rows_idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp(self.max_norm / norms.clamp(min=1e-12),
                                max=1.0)
        rows = F.embedding(rows_idx, w)
        if self.padding_idx is not None:
            # the padding positions' rows come from a detached branch:
            # their value is kept and their gradient dropped
            rows = torch.where((idx != self.padding_idx)[..., None], rows,
                               rows.detach())
        return rows

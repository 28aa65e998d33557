"""Transformer language model, ported from
``bigdl_tpu/models/transformer.py``.

``build_transformer_lm`` returns a causal decoder LM over [batch, seq]
token ids: token embedding + learned positions -> N pre-norm
TransformerBlocks -> final LayerNorm -> vocab head (log-probs per
position, so ``TimeDistributedCriterion(ClassNLLCriterion(),
size_average=True)`` trains it).  The state keys equal the JAX
package's (``0.weight``, ``2.attn.q_proj.weight``, ``9.0.0.bias``).

Not ported yet: sequence parallelism (``sp_*``), ``remat``, ``scan`` and
the decode positions of a generation trace.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module

__all__ = ["build_transformer_lm", "PositionalEmbedding"]


class PositionalEmbedding(Module):
    """Learned absolute positions added to [B, S, E] token embeddings;
    the table starts at zeros."""

    def __init__(self, max_len: int, embed_dim: int):
        super().__init__()
        self.max_len = max_len
        self.weight = torch.nn.Parameter(torch.zeros(max_len, embed_dim))

    def forward(self, x):
        return x + self.weight[None, :x.shape[1], :]


def build_transformer_lm(vocab_size: int, num_layers: int = 4,
                         embed_dim: int = 256, num_heads: int = 8,
                         max_len: int = 1024, mlp_ratio: int = 4,
                         dropout: float = 0.0, backend="auto",
                         generator: Optional[torch.Generator] = None
                         ) -> nn.Sequential:
    """Causal decoder-only LM, in the layer order of the JAX package's
    ``build_transformer_lm``."""
    model = nn.Sequential(
        nn.LookupTable(vocab_size, embed_dim, generator=generator),
        PositionalEmbedding(max_len, embed_dim))
    for _ in range(num_layers):
        model.add(nn.TransformerBlock(embed_dim, num_heads,
                                      mlp_ratio=mlp_ratio, dropout=dropout,
                                      causal=True, backend=backend,
                                      generator=generator))
    model.add(nn.LayerNorm(embed_dim))
    model.add(nn.TimeDistributed(nn.Sequential(
        nn.Linear(embed_dim, vocab_size, generator=generator),
        nn.LogSoftMax())))
    return model

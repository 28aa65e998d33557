"""Criterions (losses), ported from ``bigdl_tpu/nn/criterion.py``.

``forward(input, target)`` computes the loss; its gradient comes from
autograd, as the JAX package takes it with ``jax.grad``.  Class labels
are 0-based by default, with ``one_based=True`` for pipelines that keep
the reference's 1-based labels.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Criterion", "ClassNLLCriterion", "TimeDistributedCriterion"]


def _to_index(target, one_based: bool, device) -> torch.Tensor:
    t = torch.as_tensor(target, device=device)
    if t.is_floating_point():
        t = t.to(torch.int32)
    t = t.long()
    return t - 1 if one_based else t


class Criterion:
    """Base (``nn/abstractnn/AbstractCriterion.scala``)."""

    def update_output(self, input, target) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, input, target) -> torch.Tensor:
        return self.update_output(input, target)

    __call__ = forward


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probability input
    (``nn/ClassNLLCriterion.scala``); ``weights`` per class, averaged by
    the picked weights under ``size_average``.

    bf16 log-probs give a bf16 loss, as in the JAX package: both
    frameworks accumulate the mean (and the log-softmax sum before it)
    in f32 inside the reduction and round its result to bf16.

    Out-of-range targets give what the JAX package's
    ``take_along_axis`` gives: a target in ``[-n, 0)`` counts from the
    end (-1 is the last class); any other target outside ``[0, n)``
    picks NaN, so the loss is NaN, and sends no gradient.  A class
    weight is looked up as ``LookupTable`` looks up a row (wrapped, then
    clamped).  The rule is applied to the target with tensor ops before
    the gather, so no target reaches ``torch.gather`` out of range and
    no device-side assert can fire on the card."""

    def __init__(self, weights=None, size_average: bool = True,
                 one_based: bool = False):
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average
        self.one_based = one_based

    def update_output(self, input, target):
        t = _to_index(target, self.one_based, input.device)
        logp = input[None, :] if input.ndim == 1 else input
        n = logp.shape[1]
        t = t.reshape(logp.shape[0])
        valid = (t >= -n) & (t < n)
        t = torch.where(t < 0, t + n, t).clamp(0, n - 1)
        picked = torch.gather(logp, 1, t[:, None])[:, 0]
        picked = torch.where(valid, picked,
                             torch.full((), math.nan, dtype=picked.dtype,
                                        device=picked.device))
        if self.weights is not None:
            w = self.weights.to(input.device)[t]
            total = -torch.sum(w * picked)
            return total / torch.sum(w) if self.size_average else total
        return torch.mean(-picked) if self.size_average \
            else torch.sum(-picked)


class TimeDistributedCriterion(Criterion):
    """The inner criterion at every step of [batch, time, ...] input and
    target (``nn/TimeDistributedCriterion.scala``): the step losses are
    summed, and divided by the number of steps under ``size_average``.
    The steps run as one batched call (``torch.func.vmap`` over the time
    axis), which keeps the per-step normalisation of any inner
    criterion, a weighted one included."""

    def __init__(self, criterion: Criterion, size_average: bool = False):
        self.criterion = criterion
        self.size_average = size_average

    def update_output(self, input, target):
        t = input.shape[1]
        target = torch.as_tensor(target, device=input.device)
        losses = torch.func.vmap(self.criterion.update_output,
                                 in_dims=(1, 1))(input, target)
        total = losses.sum()
        return total / t if self.size_average else total

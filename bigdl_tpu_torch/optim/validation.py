"""Validation methods and results (``optim/ValidationMethod.scala``),
ported from ``bigdl_tpu/optim/validation.py``: Top1Accuracy,
Top5Accuracy, Loss and MAE; results merge with ``+``.

A method forms its counts on the output's device: a result's numerator
may be a 0-d tensor there, and results add as tensors.  :func:`fetch`
reads every pending numerator of a list of results to the host in one
copy, so a validation pass waits for the device once, at its end, not
once a batch.  Not ported yet: ``merge_across_processes`` and
``TreeNNAccuracy``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = [
    "ValidationResult", "AccuracyResult", "LossResult", "ValidationMethod",
    "Top1Accuracy", "Top5Accuracy", "Loss", "MAE", "fetch",
]


def _host(v):
    return v.item() if isinstance(v, torch.Tensor) else v


class ValidationResult:
    #: the numerator, a Python number or a 0-d tensor on the device
    value = 0
    count = 0

    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        return type(self)(self.value + other.value, self.count + other.count)


class AccuracyResult(ValidationResult):
    def __init__(self, correct, count: int):
        self.value, self.count = correct, int(count)

    @property
    def correct(self) -> int:
        return int(_host(self.value))

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __repr__(self):
        acc, n = self.result()
        return (f"Accuracy(correct: {self.correct}, count: {n}, "
                f"accuracy: {acc:.6f})")

    def __eq__(self, other):
        return isinstance(other, AccuracyResult) and \
            (self.correct, self.count) == (other.correct, other.count)


class LossResult(ValidationResult):
    def __init__(self, loss, count: int):
        self.value, self.count = loss, int(count)

    @property
    def loss(self) -> float:
        return float(_host(self.value))

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __repr__(self):
        mean, n = self.result()
        return f"Loss(loss: {self.loss:.6f}, count: {n}, mean: {mean:.6f})"


def fetch(results: Sequence[ValidationResult]) -> List[ValidationResult]:
    """The same results with host numerators: every tensor numerator
    crosses in one copy (as f64)."""
    pending = [r for r in results if isinstance(r.value, torch.Tensor)]
    if pending:
        host = torch.stack([r.value.double() for r in pending]).cpu()
        vals = iter(host.tolist())
        for r in pending:
            r.value = next(vals)
    return list(results)


class ValidationMethod:
    name = "ValidationMethod"
    result_type = AccuracyResult  # Loss and MAE override

    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


def _tensors(output, target):
    out = torch.as_tensor(output)
    if out.ndim == 1:
        out = out[None, :]
    t = torch.as_tensor(target, device=out.device).reshape(-1).long()
    return out, t


def _classes(out: torch.Tensor, one_based: bool) -> torch.Tensor:
    pred = out.argmax(dim=-1)
    return pred + 1 if one_based else pred


class Top1Accuracy(ValidationMethod):
    """(``ValidationMethod.scala:170``)."""

    name = "Top1Accuracy"

    def __init__(self, one_based: bool = False):
        self.one_based = one_based

    def __call__(self, output, target):
        out, t = _tensors(output, target)
        return AccuracyResult((_classes(out, self.one_based) == t).sum(),
                              t.numel())


class Top5Accuracy(ValidationMethod):
    """(``ValidationMethod.scala:218``)."""

    name = "Top5Accuracy"

    def __init__(self, one_based: bool = False):
        self.one_based = one_based

    def __call__(self, output, target):
        out, t = _tensors(output, target)
        top5 = out.topk(min(5, out.shape[-1]), dim=-1).indices
        if self.one_based:
            top5 = top5 + 1
        return AccuracyResult((top5 == t[:, None]).any(dim=1).sum(),
                              t.numel())


class Loss(ValidationMethod):
    """Mean criterion loss (``ValidationMethod.scala:312``)."""

    name = "Loss"
    result_type = LossResult

    def __init__(self, criterion=None):
        if criterion is None:
            from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

            criterion = ClassNLLCriterion()
        self.criterion = criterion

    def __call__(self, output, target):
        out = torch.as_tensor(output)
        t = torch.as_tensor(target, device=out.device)
        n = out.shape[0]
        return LossResult(self.criterion.forward(out, t).double() * n, n)


class MAE(ValidationMethod):
    """Mean absolute error of the argmax-decoded predictions against the
    targets (``ValidationMethod.scala:332``)."""

    name = "MAE"
    result_type = LossResult

    def __init__(self, one_based: bool = False):
        self.one_based = one_based

    def __call__(self, output, target):
        out = torch.as_tensor(output)
        if out.ndim == 1:
            out = out[None, :]
        pred = _classes(out, self.one_based).double()
        t = torch.as_tensor(np.asarray(target, np.float64)
                            if not isinstance(target, torch.Tensor)
                            else target, device=out.device)
        t = t.reshape(-1).double()
        return LossResult((pred - t).abs().sum(), t.numel())

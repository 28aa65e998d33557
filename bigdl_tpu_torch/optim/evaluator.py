"""Evaluator (``optim/Evaluator.scala:37``), ported from
``bigdl_tpu/optim/evaluator.py``: validation methods over a dataset
through the ported ``EvalStep``.  Counts stay on the device until the
end of the pass, which reads them to the host in one copy."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult, fetch)

__all__ = ["Evaluator", "evaluate_batches"]


def evaluate_batches(step, batches, methods: Sequence[ValidationMethod]
                     ) -> Tuple[Optional[List[ValidationResult]], int]:
    """Run ``step`` (an ``EvalStep``) over ``batches`` and sum each
    method's results; returns (host results or None for no batch, the
    records seen)."""
    results: Optional[List[ValidationResult]] = None
    count = 0
    for batch in batches:
        out = step.run(batch.get_input())
        target = batch.get_target()
        rs = [m(out, target) for m in methods]
        results = rs if results is None else [a + b
                                              for a, b in zip(results, rs)]
        count += batch.size()
    return (None if results is None else fetch(results)), count


class Evaluator:
    """``device`` is ``cuda`` unless the caller passes ``"cpu"``."""

    def __init__(self, model, batch_size: int = 32, device=None):
        self.model = model
        self.batch_size = batch_size
        self.device = device

    def evaluate(self, dataset, methods: Sequence[ValidationMethod]
                 ) -> List[Tuple[ValidationResult, ValidationMethod]]:
        from bigdl_tpu_torch.parallel.train_step import EvalStep

        if isinstance(dataset, (list, tuple)):
            dataset = DataSet.array(list(dataset)).transform(
                SampleToMiniBatch(self.batch_size))
        step = EvalStep(self.model, device=self.device)
        results, _ = evaluate_batches(step, dataset.data(train=False),
                                      methods)
        return list(zip(results or [], methods))

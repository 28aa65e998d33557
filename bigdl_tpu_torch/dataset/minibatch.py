"""MiniBatch (``dataset/MiniBatch.scala:33``), ported from
``bigdl_tpu/dataset/minibatch.py``: a stacked batch of Samples with
``size``, ``slice``, ``get_input`` and ``get_target`` and the padding
strategies."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import PaddingParam, Sample

__all__ = ["MiniBatch"]


def _pad_stack(arrays: List[np.ndarray],
               param: Optional[PaddingParam]) -> np.ndarray:
    """Stack arrays, padding every axis to the largest extent (and the
    first to ``param.fixed_length`` when it is set)."""
    shapes = [a.shape for a in arrays]
    if len(set(shapes)) == 1 and (param is None
                                  or param.fixed_length is None):
        return np.stack(arrays)
    pad_value = param.padding_value if param else 0.0
    target = [max(s[d] for s in shapes) for d in range(arrays[0].ndim)]
    if param is not None and param.fixed_length is not None:
        if param.fixed_length < target[0]:
            raise ValueError(f"fixed_length {param.fixed_length} < longest "
                             f"sample {target[0]}")
        target[0] = param.fixed_length
    out = np.full((len(arrays), *target), pad_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, d) for d in a.shape)] = a
    return out


class MiniBatch:
    def __init__(self, inputs, targets=None):
        self.inputs: List[np.ndarray] = \
            inputs if isinstance(inputs, list) else [inputs]
        self.targets: List[np.ndarray] = [] if targets is None else (
            targets if isinstance(targets, list) else [targets])

    @staticmethod
    def from_samples(samples: Sequence[Sample],
                     feature_padding: Optional[PaddingParam] = None,
                     label_padding: Optional[PaddingParam] = None
                     ) -> "MiniBatch":
        inputs = [_pad_stack([s.features[i] for s in samples],
                             feature_padding)
                  for i in range(len(samples[0].features))]
        targets = [_pad_stack([s.labels[i] for s in samples], label_padding)
                   for i in range(len(samples[0].labels))]
        return MiniBatch(inputs, targets or None)

    def size(self) -> int:
        return self.inputs[0].shape[0]

    def get_input(self):
        return self.inputs[0] if len(self.inputs) == 1 else self.inputs

    def get_target(self):
        if not self.targets:
            return None
        return self.targets[0] if len(self.targets) == 1 else self.targets

    def slice(self, offset: int, length: int) -> "MiniBatch":
        return MiniBatch(
            [a[offset:offset + length] for a in self.inputs],
            [a[offset:offset + length] for a in self.targets] or None)

    def __repr__(self):
        return (f"MiniBatch(inputs={[a.shape for a in self.inputs]}, "
                f"targets={[a.shape for a in self.targets]})")

"""Sample — one labeled record (``dataset/Sample.scala:31,126``), ported
from ``bigdl_tpu/dataset/sample.py``."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["Sample", "PaddingParam"]


class Sample:
    """Feature tensor(s) and label tensor(s), host-side numpy."""

    def __init__(self, features, labels=None):
        self.features: List[np.ndarray] = [np.asarray(f)
                                           for f in _as_list(features)]
        self.labels: List[np.ndarray] = [np.asarray(v)
                                         for v in _as_list(labels)]

    @property
    def feature(self) -> np.ndarray:
        return self.features[0]

    @property
    def label(self) -> np.ndarray:
        return self.labels[0]

    def feature_size(self):
        return [f.shape for f in self.features]

    def label_size(self):
        return [v.shape for v in self.labels]

    def __repr__(self):
        return (f"Sample(features={[f.shape for f in self.features]}, "
                f"labels={[v.shape for v in self.labels]})")


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class PaddingParam:
    """Padding strategy (``dataset/MiniBatch.scala`` PaddingParam): the
    pad value, and an optional fixed length of the first (time) axis."""

    def __init__(self, padding_value: float = 0.0,
                 fixed_length: Optional[int] = None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length

"""Composable data transformers (``dataset/Transformer.scala:44-86``),
ported from ``bigdl_tpu/dataset/transformer.py``.

A Transformer maps ``Iterator[A] -> Iterator[B]`` and composes with
``>>`` (the reference's ``->``).  Transformers run on the host (numpy);
the device only sees finished MiniBatches.  The image and text chains
are not ported yet.
"""

from __future__ import annotations

import copy
from typing import Iterable, Iterator, List, Optional

from bigdl_tpu_torch.dataset.minibatch import MiniBatch

__all__ = ["Transformer", "ChainedTransformer", "SampleToMiniBatch",
           "Identity"]


class Transformer:
    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def clone_transformer(self) -> "Transformer":
        return copy.deepcopy(self)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second(self.first(it))


class Identity(Transformer):
    def apply(self, it):
        return it


class SampleToMiniBatch(Transformer):
    """Batch Samples into MiniBatches (``dataset/Transformer.scala:309``),
    padding variable-length samples by ``feature_padding_param`` /
    ``label_padding_param``; a short last batch is kept unless
    ``drop_last``.  ``partition_num`` is accepted for the reference's
    signature."""

    def __init__(self, batch_size: int, feature_padding_param=None,
                 label_padding_param=None,
                 partition_num: Optional[int] = None,
                 drop_last: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding_param
        self.label_padding = label_padding_param
        self.drop_last = drop_last

    def apply(self, it):
        buf: List = []
        for sample in it:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf, self.feature_padding,
                                             self.label_padding)
                buf = []
        if buf and not self.drop_last:
            yield MiniBatch.from_samples(buf, self.feature_padding,
                                         self.label_padding)

"""LocalPredictor (``optim/LocalPredictor.scala:37``), ported from
``bigdl_tpu/optim/predictor.py``: batched inference over Samples, a
dataset or an array, through the ported ``EvalStep`` (the JAX class
goes through the serving executor's compile cache, which the eager port
does not need).  The outputs stay on the device until the end and come
back to the host in one copy."""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch

__all__ = ["LocalPredictor", "Predictor"]


class LocalPredictor:
    """``device`` is ``cuda`` unless the caller passes ``"cpu"``."""

    def __init__(self, model, batch_size: int = 32, device=None):
        self.model = model
        self.batch_size = batch_size
        self.device = device
        self._step = None

    def _batches(self, data):
        if isinstance(data, (list, tuple)) and data \
                and isinstance(data[0], Sample):
            yield from DataSet.array(list(data)).transform(
                SampleToMiniBatch(self.batch_size)).data(train=False)
        elif isinstance(data, AbstractDataSet):
            yield from data.data(train=False)
        else:  # a raw array: batch it
            arr = np.asarray(data)
            for i in range(0, len(arr), self.batch_size):
                yield MiniBatch([arr[i:i + self.batch_size]])

    def predict(self, data) -> np.ndarray:
        from bigdl_tpu_torch.parallel.train_step import EvalStep

        if self._step is None:
            self._step = EvalStep(self.model, device=self.device)
        outs = [self._step.run(b.get_input()) for b in self._batches(data)]
        if not outs:
            return np.zeros((0,))
        return torch.cat(outs).cpu().numpy()

    def predict_class(self, data, one_based: bool = False) -> np.ndarray:
        pred = self.predict(data).argmax(axis=-1)
        return pred + 1 if one_based else pred


Predictor = LocalPredictor

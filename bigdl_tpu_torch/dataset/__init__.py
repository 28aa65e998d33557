"""bigdl_tpu_torch.dataset — the host-side data pipeline, ported from
``bigdl_tpu/dataset/``: samples, minibatches, transformers, the local
datasets and the MNIST / CIFAR-10 readers.  Everything here is numpy on
the host; the training loop moves finished batches to the device."""

from bigdl_tpu_torch.dataset.dataset import (  # noqa: F401
    AbstractDataSet, DataSet, LocalDataSet,
)
from bigdl_tpu_torch.dataset.minibatch import MiniBatch  # noqa: F401
from bigdl_tpu_torch.dataset.sample import PaddingParam, Sample  # noqa: F401
from bigdl_tpu_torch.dataset.transformer import (  # noqa: F401
    ChainedTransformer, SampleToMiniBatch, Transformer,
)

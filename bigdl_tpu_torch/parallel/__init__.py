"""bigdl_tpu_torch.parallel — the training and evaluation steps (one
device so far)."""

from bigdl_tpu_torch.parallel.train_step import (  # noqa: F401
    EvalStep, TrainStep, bf16_truncate,
)

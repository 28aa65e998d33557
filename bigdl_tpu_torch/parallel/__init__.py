"""bigdl_tpu_torch.parallel — the training step (one device so far)."""

from bigdl_tpu_torch.parallel.train_step import TrainStep  # noqa: F401

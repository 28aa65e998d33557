"""Inference serving: HTTP frontend -> bounded queue -> continuous
batcher -> bucketed executor (ported from ``bigdl_tpu/serving``)."""

from bigdl_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher, QueueFullError, Request,
)
from bigdl_tpu_torch.serving.buckets import BucketPolicy, pow2_buckets  # noqa: F401
from bigdl_tpu_torch.serving.executor import BucketedExecutor  # noqa: F401
from bigdl_tpu_torch.serving.server import ModelServer, serve_model  # noqa: F401

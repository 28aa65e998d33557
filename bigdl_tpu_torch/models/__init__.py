"""Model zoo of the port (so far: Inception-v1)."""

from bigdl_tpu_torch.models.inception import (  # noqa: F401
    build_inception_v1, inception_layer_v1,
)

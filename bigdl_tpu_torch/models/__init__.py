"""Model zoo of the port (so far: Inception-v1 and the transformer LM)."""

from bigdl_tpu_torch.models.inception import (  # noqa: F401
    build_inception_v1, inception_layer_v1,
)
from bigdl_tpu_torch.models.transformer import (  # noqa: F401
    build_transformer_lm, PositionalEmbedding,
)

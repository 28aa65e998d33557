"""Model zoo of the port (so far: Inception-v1, Inception-v2, ResNet
and the transformer LM)."""

from bigdl_tpu_torch.models.inception import (  # noqa: F401
    build_inception_v1, build_inception_v2, inception_layer_v1,
    inception_layer_v2,
)
from bigdl_tpu_torch.models.transformer import (  # noqa: F401
    build_transformer_lm, PositionalEmbedding,
)
from bigdl_tpu_torch.models.resnet import (  # noqa: F401
    basic_block, bottleneck, build_resnet, build_resnet_cifar,
)

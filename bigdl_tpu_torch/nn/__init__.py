"""bigdl_tpu_torch.nn — the module system and the layers ported so far,
under the JAX package's names (``bigdl_tpu/nn/__init__.py``)."""

from bigdl_tpu_torch.nn.module import (  # noqa: F401
    Module, Container, Sequential, state_dict, parameters, load_state_dict,
)
from bigdl_tpu_torch.nn.criterion import *  # noqa: F401,F403
from bigdl_tpu_torch.nn import init  # noqa: F401
from bigdl_tpu_torch.nn.layers.activation import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.linear import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.conv import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.pooling import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.normalization import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.shape import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.container_ext import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.embedding import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers.attention import *  # noqa: F401,F403

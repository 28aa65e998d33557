"""bigdl_tpu_torch.optim — optimization methods, learning-rate
schedules and regularizers."""

from bigdl_tpu_torch.optim.optim_method import *  # noqa: F401,F403
from bigdl_tpu_torch.optim.regularizer import *  # noqa: F401,F403

"""bigdl_tpu_torch.optim — optimization methods ported so far."""

from bigdl_tpu_torch.optim.optim_method import *  # noqa: F401,F403

"""bigdl_tpu_torch.optim — optimization methods, learning-rate
schedules, regularizers, triggers, validation methods, the health
policy, the evaluator and predictor, and the one-device Optimizer."""

from bigdl_tpu_torch.optim.optim_method import *  # noqa: F401,F403
from bigdl_tpu_torch.optim.regularizer import *  # noqa: F401,F403
from bigdl_tpu_torch.optim.trigger import Trigger  # noqa: F401
from bigdl_tpu_torch.optim.metrics import Metrics  # noqa: F401
from bigdl_tpu_torch.optim.validation import *  # noqa: F401,F403
from bigdl_tpu_torch.optim.health import HealthError, HealthPolicy  # noqa: F401
from bigdl_tpu_torch.optim.evaluator import Evaluator  # noqa: F401
from bigdl_tpu_torch.optim.predictor import (  # noqa: F401
    LocalPredictor, Predictor,
)
from bigdl_tpu_torch.optim.optimizer import (  # noqa: F401
    LocalOptimizer, Optimizer,
)

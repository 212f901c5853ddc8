"""The ported training engine: optimizers and schedules, the step, the
callbacks and the loop (one device)."""

from . import callbacks  # noqa: F401
from .loop import Trainer  # noqa: F401
from .optimizers import (  # noqa: F401
    Optimizer,
    OptimizerConfig,
    make_optimizer,
    make_schedule,
)
from .step import (  # noqa: F401
    StepOptions,
    TrainState,
    init_train_state,
    make_train_step,
    step_nonfinite,
)

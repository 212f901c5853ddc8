"""The ported training engine: optimizers and schedules, the step, the
callbacks, the loop, checkpointing and the distributed evaluator."""

from . import callbacks, checkpoint  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointConfig,
    Checkpointer,
    PreemptionSaved,
    init_or_restore,
)
from .evaluation import ShardedEvaluator, derive_metrics  # noqa: F401
from .loop import Trainer  # noqa: F401
from .optimizers import (  # noqa: F401
    MultiOptimizer,
    Optimizer,
    OptimizerConfig,
    make_multi_optimizer,
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

"""Fault injection and automatic recovery — the ported subset of
``distributed_tensorflow_tpu/resilience``: the retry executor with seeded
jitter (``retry.py``), the in-process ``Supervisor`` that restarts
``Trainer.fit`` from the newest valid checkpoint (``supervisor.py``), and
the run-level and disk faults that drive them (``faults.py``). Liveness,
the fleets, the fleet-side faults and the numeric-anomaly defense are
ROADMAP Queue A item 6."""

from .faults import (  # noqa: F401
    AsyncCommitKill,
    CorruptCheckpoint,
    DataError,
    FaultCallback,
    FaultClock,
    FaultPlan,
    FaultyIterator,
    NaNBatch,
    Sigterm,
    SlowWriter,
    TransientIOError,
    corrupt_shard,
    truncate_shard,
)
from .retry import (  # noqa: F401
    AttemptTimeout,
    RetryExhausted,
    RetryPolicy,
    retry_call,
)
from .supervisor import (  # noqa: F401
    FATAL,
    POISONED,
    PREEMPTION,
    STALLED,
    TRANSIENT,
    Supervisor,
    SupervisorConfig,
    SupervisorExhausted,
    classify_failure,
)

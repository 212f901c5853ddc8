"""Paged KV-cached decode with continuous batching, on PyTorch + CUDA.

The port of the JAX package's serve engine (paged path): block pool and
allocator (kv_cache.py), scheduler (a copy), sampling, the paged step
functions (decode.py) and ``ServeEngine``. ``python -m
distributed_tensorflow_tpu_torch.serve`` is the command-line demo.
"""

from .decode import (  # noqa: F401
    copy_block,
    paged_decode_step,
    paged_prefill_chunk,
    paged_verify_step,
    prefill_bucket,
)
from .engine import ServeEngine, StepStats  # noqa: F401
from .kv_cache import (  # noqa: F401
    BlockAllocator,
    NoFreeBlocks,
    PagedKVCache,
    init_paged_cache,
)
from .sampling import sample, spec_verify_greedy, spec_verify_sample  # noqa: F401
from .scheduler import (  # noqa: F401
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_MAX_LEN,
    FINISH_MAX_NEW,
    FINISH_REASONS,
    FINISH_TIMEOUT,
    QueueFull,
    Request,
    Scheduler,
    SchedulerClosed,
)

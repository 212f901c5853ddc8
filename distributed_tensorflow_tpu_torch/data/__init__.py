"""Input streams of the ported training path (the causal-LM subset of
``distributed_tensorflow_tpu/data``)."""

from .text import (  # noqa: F401
    IGNORE_INDEX,
    SyntheticLM,
    TextDataConfig,
    TokenFileLM,
    batch_rng,
    local_batch_size,
    make_text_dataset,
)

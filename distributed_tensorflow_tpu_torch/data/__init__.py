"""Input streams of the ported training paths (the causal-LM and image
classification subsets of ``distributed_tensorflow_tpu/data``)."""

from .pipeline import (  # noqa: F401
    DataConfig,
    NpzDataset,
    SyntheticClassification,
    batch_rng,
    local_batch_size,
    make_dataset,
)
from .text import (  # noqa: F401
    IGNORE_INDEX,
    SyntheticLM,
    TextDataConfig,
    TokenFileLM,
    make_text_dataset,
)

"""Input streams of the ported training paths (the LM, MLM and image
classification subsets of ``distributed_tensorflow_tpu/data``)."""

from .pipeline import (  # noqa: F401
    DataConfig,
    DevicePut,
    NpzDataset,
    Prefetcher,
    StagedBatch,
    SyntheticClassification,
    batch_rng,
    local_batch_size,
    make_dataset,
)
from .text import (  # noqa: F401
    IGNORE_INDEX,
    SyntheticLM,
    SyntheticMLM,
    TextDataConfig,
    TokenFileLM,
    TokenFileMLM,
    make_text_dataset,
    mlm_mask_batch,
    resolved_max_predictions,
)

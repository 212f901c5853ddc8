"""Input streams of the ported training paths (the LM, MLM, image
classification and CTR subsets of ``distributed_tensorflow_tpu/data``:
synthetic streams, npz, flat records, JPEG records, CTR records and the
tf.data adapter)."""

from . import tfdata  # noqa: F401  (TensorFlow imported inside host_stream)
from .pipeline import (  # noqa: F401
    DataConfig,
    DevicePut,
    NpzDataset,
    Prefetcher,
    RetryingIterator,
    StagedBatch,
    SyntheticClassification,
    batch_rng,
    local_batch_size,
    make_dataset,
)
from .recsys import (  # noqa: F401
    CTRRecordDataset,
    RecsysConfig,
    SyntheticCTR,
    ctr_record_dtype,
    make_ctr_record_file,
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

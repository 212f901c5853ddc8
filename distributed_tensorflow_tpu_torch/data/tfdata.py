"""tf.data adapter: the host-batch contract driven from a tf.data.Dataset —
the port's counterpart of ``distributed_tensorflow_tpu/data/tfdata.py``.

An existing tf.data input pipeline (TFRecord readers, tf.image
augmentation, interleave trees) becomes an iterable of this process's
numpy dict batches of ``global_batch / process_count`` rows, the
contract of ``data/pipeline.py``, without a rewrite::

    parts = WorkloadParts(...,
        dataset_fn=lambda start: tfdata.host_stream(
            make_ds, cfg.data.global_batch_size, start_index=start))

The process index and count are ``parallel.cluster``'s (the JAX module
reads ``jax.process_index/count``). TensorFlow is imported inside
``host_stream`` only: the port needs it nowhere else, and a machine
without it imports this module all the same.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np

from ..parallel import cluster
from .pipeline import local_batch_size


def shard_for_host(ds):
    """``Dataset.shard(num_workers, task_index)`` over the processes: each
    reads a disjoint 1/n slice. Apply at the file or example level, before
    batching."""
    return ds.shard(cluster.process_count(), cluster.process_index())


def host_stream(make_dataset: Callable[[], Any], global_batch_size: int, *,
                start_index: int = 0, shuffle_buffer: int = 0, seed: int = 0,
                repeat: bool = True, shard: bool = True) -> Iterator[dict]:
    """An element-level tf.data factory as this process's stream of numpy
    dict batches.

    make_dataset: returns an UNBATCHED tf.data.Dataset of dict elements;
        called once a stream.
    start_index: batches to skip (the runner's resume offset,
        ``dataset_fn(start_step)``).
    shuffle_buffer: > 0 shuffles each epoch with a per-process seed (the
        slices stay disjoint).
    shard: False when ``make_dataset`` shards per process itself
        (sharding twice would drop data).
    """
    import tensorflow as tf

    local_bs = local_batch_size(global_batch_size)
    ds = make_dataset()
    if shard:
        ds = shard_for_host(ds)
    if shuffle_buffer > 0:
        # shuffle before repeat: each epoch reshuffles, and no buffer
        # blends two epochs
        ds = ds.shuffle(shuffle_buffer, seed=seed * 1_000_003 + cluster.process_index(),
                        reshuffle_each_iteration=True)
    if repeat:
        ds = ds.repeat()
    ds = ds.batch(local_bs, drop_remainder=True)
    if start_index:
        ds = ds.skip(start_index)
    ds = ds.prefetch(tf.data.AUTOTUNE)
    for elem in ds.as_numpy_iterator():
        yield {k: np.asarray(v) for k, v in elem.items()}

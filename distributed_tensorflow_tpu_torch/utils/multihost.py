"""Cross-process divergence checks — the port's counterpart of
``distributed_tensorflow_tpu/utils/multihost.py``.

Data-parallel processes must agree on the step count, the seeds, the loss
they act on: one that diverges deadlocks a collective or silently trains
another model. ``assert_same_across_hosts`` fingerprints a small tree on
every process and compares; enable the debug checks with
``DTF_TPU_CHECK_DIVERGENCE=1``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any

import numpy as np
import torch


def divergence_checks_enabled() -> bool:
    return os.environ.get("DTF_TPU_CHECK_DIVERGENCE", "0") not in ("0", "", "false")


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _fingerprint(tree: Any) -> np.ndarray:
    """Stable 64-bit host-side fingerprint of a small tree (dicts by
    sorted key, lists, tensors, arrays, scalars)."""
    h = hashlib.blake2b(digest_size=8)
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.asarray(leaf).tobytes())
    return np.frombuffer(h.digest(), dtype=np.int64)


def _comm_device():
    import torch.distributed as dist

    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def assert_same_across_hosts(tree: Any, name: str = "value") -> None:
    """Raise on every process if any process disagrees on ``tree`` (step
    counters, seeds, loss scalars: cheap things, not parameters). No-op in
    a single process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    fp = torch.from_numpy(_fingerprint(tree).copy()).to(_comm_device())
    parts = [torch.empty_like(fp) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, fp)
    fps = [int(p.item()) for p in parts]
    if len(set(fps)) != 1:
        raise AssertionError(f"Cross-host divergence on '{name}': fingerprints {fps} differ "
                             f"across processes")


def broadcast_from_chief(tree: Any) -> Any:
    """Every process adopts process 0's ``tree`` (picklable: config
    resolution, run ids). No-op in a single process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]

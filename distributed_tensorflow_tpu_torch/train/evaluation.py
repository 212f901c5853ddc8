"""Distributed evaluation, bit-exactly — the port's counterpart of
``distributed_tensorflow_tpu/train/evaluation.py``.

Every process evaluates its rows of each global eval batch with the full
weights; a sharded evaluation must report the same loss a serial
evaluator would, to the bit, whatever the number of processes. The
construction pins the reduction order to the program:

1. each process runs ``eval_fn`` on its rows at their own (local) shape,
   under ``torch.no_grad()`` with the model in eval mode: the program a
   serial evaluator runs chunk by chunk;
2. the per-process partial sums are gathered to every process in rank
   order, stacked ``[shards, ...]`` (no reduction on the device or in
   the collective);
3. the host reduces them in float64, shard-major, in a fixed order, and
   then across batches.

One process walking the same chunks in the same order computes the same
float sequence, so the equality is structural
(``tests/test_torch_evaluation.py``, ``tests/torch_dp_worker.py``).

The gather moves host objects (``torch.distributed.all_gather_object`` of
numpy arrays): it works over gloo on the CPU, over gloo with the ranks
on one card (gloo has no CUDA all-gather) and over NCCL (which takes no
CPU tensors), and a float's bits survive it. The partials leave the card
once a batch; that read is the evaluator's only synchronisation.

Each process's stream gives it its rows of the global batch, as in
training. The gather runs over the batch axes (``data`` x ``fsdp``)
alone: the ``model``, ``seq`` and ``pipe`` ranks of a data shard read the
same rows and end with the same statistics (a pipeline's output is
broadcast to every stage), so each data shard is counted once and every
rank holds the totals. The JAX evaluator has a fallback, outside its contract, for a
batch whose rows do not divide by the mesh's batch shards: one process
holds the whole batch for several devices and evaluates it whole. Here a
process is a shard and holds only its own rows (``data.pipeline.
local_batch_size`` refuses a global batch that does not divide by the
process count before any step), and ranks with unequal row counts would
still reduce exactly (the gathered partials are fixed-size sums), so the
fallback has no case in the port.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..obs import flightrec as flightrec_lib
from ..obs.registry import Registry, default_registry
from ..parallel.mesh import BATCH_AXES, mesh_axis_size
from ..parallel.sharding import put_host_batch
from ..utils import metrics as metrics_lib

__all__ = ["EVAL_STEPS", "ShardedEvaluator", "batch_shards", "derive_metrics"]

#: metric name: evaluation batches executed
EVAL_STEPS = "eval_steps_total"


def batch_shards(mesh) -> int:
    """How many ways the batch dimension splits on this mesh (1 without one)."""
    return 1 if mesh is None else mesh_axis_size(mesh, BATCH_AXES)


def _host(out: dict[str, Any]) -> dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


class ShardedEvaluator:
    """The distributed eval loop: per-process partials, gathered in rank
    order, float64 accumulation on the host, obs instrumentation.

    ``eval_fn(batch) -> dict`` of SUMMED statistics (scalars or
    fixed-size arrays) over a batch of tensors on
    the model's device. Each executed eval batch ticks
    ``eval_steps_total``; each pass emits ``eval_start`` / ``eval_end``
    flight-recorder events."""

    def __init__(self, eval_fn: Callable[[dict], dict], mesh=None,
                 registry: Registry | None = None, flightrec=None):
        self.eval_fn = eval_fn
        self.mesh = mesh
        self.shards = batch_shards(mesh)
        self.group = None if self.shards == 1 else mesh.group(BATCH_AXES)
        self.registry = registry if registry is not None else default_registry()
        self.flightrec = (flightrec if flightrec is not None
                          else flightrec_lib.default_recorder())
        self._m_steps = self.registry.counter(EVAL_STEPS, "evaluation batches executed")

    def _gather(self, vals: dict[str, np.ndarray]) -> list[dict[str, np.ndarray]]:
        """Every rank's partials, in rank order."""
        if self.group is None:
            return [vals]
        import torch.distributed as dist

        parts: list = [None] * self.shards
        dist.all_gather_object(parts, vals, group=self.group)
        return parts

    def run(self, state, batches: Iterable[Any], num_batches: int | None = None,
            step: int | None = None) -> dict[str, Any]:
        """Evaluate ``num_batches`` of this process's host batches (its
        rows of each global batch) with ``state.model``; returns the
        float64 totals over every process's rows of every summed
        statistic. Derive ratios with ``derive_metrics``."""
        model = state.model
        device = next(model.parameters()).device
        self.flightrec.emit("eval_start", step=step, shards=self.shards)
        totals: dict[str, Any] = {}
        n = 0
        was_training = model.training
        model.eval()
        try:
            for batch in itertools.islice(batches, num_batches):
                with torch.no_grad():
                    out = _host(self.eval_fn(put_host_batch(batch, device)))
                parts = self._gather(out)
                # shard-major, fixed-order host reduction
                for k in parts[0]:
                    v = np.stack([np.asarray(p[k], np.float64) for p in parts]).sum(axis=0)
                    totals[k] = totals.get(k, 0.0) + v
                n += 1
                self._m_steps.inc()
        finally:
            model.train(was_training)
        self.flightrec.emit("eval_end", step=step, batches=n)
        return totals


def derive_metrics(totals: dict[str, Any], auc_prefix: str = "") -> dict:
    """Scalar metric dict from summed totals: keeps the scalars, derives
    accuracy / top5_accuracy / loss ratios over ``count``, and folds the
    AUC histograms (``utils/metrics.py``) into ``<auc_prefix>auc``
    (omitted when undefined: a one-class stream makes AUC NaN)."""
    result = {k: float(v) for k, v in totals.items() if np.ndim(v) == 0}
    for summed, ratio in (("correct", "accuracy"), ("top5_correct", "top5_accuracy"),
                          ("loss_sum", "loss")):
        if summed in result and result.get("count"):
            result[ratio] = result[summed] / result["count"]
    if "auc_pos_hist" in totals and "auc_neg_hist" in totals:
        auc = metrics_lib.auc_from_histograms(totals["auc_pos_hist"], totals["auc_neg_hist"])
        if np.isfinite(auc):
            result[auc_prefix + "auc"] = auc
    return result

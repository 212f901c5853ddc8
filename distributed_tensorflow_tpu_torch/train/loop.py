"""Host run loop — the port's counterpart of ``distributed_tensorflow_tpu/
train/loop.py``: plain Python driving the step, callbacks over its
metrics, and the loop's causal events in the flight recorder
(``train_start``, ``step_start``, ``step_end``, ``train_stop``,
``train_exception``). PyTorch queues work on the card and returns, so the
host prepares step N+1 while N runs; only cadence'd callbacks wait. Each
process feeds its own rows (a data-parallel step averages over the mesh,
``train/step.py``); a ``Prefetcher`` with ``DevicePut`` hands the loop
batches already on the card. No donation, no checkpoint (ROADMAP Queue A
item 2.3): an unhandled exception dumps the flight recorder as a
postmortem and re-raises."""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from ..data.pipeline import StagedBatch
from ..obs import flightrec as flightrec_lib
from . import step as step_lib
from .callbacks import Callback

logger = logging.getLogger(__name__)


class Trainer:
    """Owns the step function, the state, the data feed, the callbacks."""

    def __init__(self, train_step: Callable, state: step_lib.TrainState,
                 callbacks: Sequence[Callback] = (), flightrec=None,
                 postmortem_dir: str | None = None):
        self.train_step = train_step
        self.state = state
        self.device = next(state.model.parameters()).device
        self.callbacks = list(callbacks)
        self._stop_reason: str | None = None
        self.failed = False  # set when fit() aborts on an exception
        self.flightrec = (flightrec if flightrec is not None
                          else flightrec_lib.default_recorder())
        self.postmortem_dir = postmortem_dir

    # -- control ----------------------------------------------------------
    def request_stop(self, reason: str = "") -> None:
        if self._stop_reason is None:
            self._stop_reason = reason or "requested"

    @property
    def should_stop(self) -> bool:
        return self._stop_reason is not None

    @property
    def stop_reason(self) -> str | None:
        return self._stop_reason

    # -- data -------------------------------------------------------------
    def put_batch(self, batch) -> dict[str, torch.Tensor]:
        """A batch on the state's device: a ``StagedBatch`` (``DevicePut``)
        once its copy is waited for, tensors already there as they are,
        a host batch copied from pageable memory (an unprefetched stream)."""
        if isinstance(batch, StagedBatch):
            return batch.wait()
        return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
                .to(self.device, non_blocking=True) for k, v in batch.items()}

    # -- loop -------------------------------------------------------------
    def fit(self, data: Iterable[Any], num_steps: int | None = None) -> step_lib.TrainState:
        step_now = self.state.step
        rec = self.flightrec
        rec.emit("train_start", step=step_now)
        data_iter = None
        try:
            for cb in self.callbacks:
                cb.on_train_start(self)
            data_iter = iter(data)
            while not self.should_stop:
                if num_steps is not None and step_now >= num_steps:
                    self.request_stop(f"num_steps={num_steps}")
                    break
                try:
                    batch = next(data_iter)
                except StopIteration:
                    self.request_stop("data exhausted")
                    break
                rec.emit("step_start", step=step_now + 1)
                self.state, metrics = self.train_step(self.state, self.put_batch(batch))
                if step_lib.step_nonfinite(metrics):
                    # the step kept the old state: fail fast before counting it
                    raise FloatingPointError(
                        f"non-finite loss/gradients at step {step_now + 1} "
                        "(the update was skipped)")
                step_now += 1
                for cb in self.callbacks:
                    cb.on_step_end(self, step_now, metrics)
                rec.emit("step_end", step=step_now)
        except BaseException as e:
            self.failed = True
            rec.emit("train_exception", step=step_now, etype=type(e).__name__,
                     error=repr(e)[:200])
            flightrec_lib.dump_postmortem(rec, self.postmortem_dir,
                                          reason=f"train_exception:{type(e).__name__}")
            raise
        finally:
            close = getattr(data_iter, "close", None)
            if close is not None:  # a Prefetcher's worker stops and drains
                close()
            for cb in self.callbacks:
                cb.on_train_end(self)
        rec.emit("train_stop", step=step_now, reason=self._stop_reason or "")
        if self._stop_reason:
            logger.info("training stopped: %s", self._stop_reason)
        return self.state

"""Loss adapters for models that return logits — the port's counterpart of
``distributed_tensorflow_tpu/models/common.py`` (the train engine's loss
contract here: ``loss_fn(batch, generator) -> (loss, aux metrics)``).

A model with BatchNorm updates its running-statistics buffers in its
train forward, so the loss carries no separate model state: the JAX
package's ``new_model_state`` is the model's buffers after the call."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def classification_loss_fn(model: torch.nn.Module, *, label_smoothing: float = 0.0
                           ) -> Callable:
    """``loss_fn(batch, generator=None)`` for ``batch = {"image"|"x": ...,
    "label": int}``: softmax cross-entropy of the f32 logits of
    ``model(x, train=True)``, the mean over the batch; with
    ``label_smoothing`` the targets are ``(1 - a) * onehot + a / K``
    (optax.smooth_labels). Aux: ``accuracy``. The model's forward gets the
    step's ``generator`` (the MLP's and the CNN's dropout draw from it;
    ResNet takes it and draws nothing). (The JAX version's
    ``weight_decay`` in the loss is not ported: the workloads put their L2
    in the optimizer.)"""

    def loss_fn(batch, generator=None):
        x = batch["image"] if "image" in batch else batch["x"]
        labels = batch["label"].long()
        logits = model(x, train=True, generator=generator)
        logp = F.log_softmax(logits.float(), dim=-1)
        if label_smoothing > 0:
            k = logits.shape[-1]
            target = F.one_hot(labels, k).float() * (1.0 - label_smoothing) + label_smoothing / k
            loss = -(target * logp).sum(-1).mean()
        else:
            loss = -logp.gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn


def classification_eval_fn(model: torch.nn.Module) -> Callable:
    """``eval_fn(batch) -> {"loss_sum", "correct", "top5_correct",
    "count"}``: SUMMED statistics (shards and batches add exactly) of
    ``model(x, train=False)`` — BatchNorm on its running statistics, so no
    all-reduce — with no gradient. Top-5 clamps k to the class count."""

    @torch.no_grad()
    def eval_fn(batch):
        x = batch["image"] if "image" in batch else batch["x"]
        labels = batch["label"].long()
        logits = model(x, train=False).float()
        loss = -F.log_softmax(logits, dim=-1).gather(-1, labels[:, None]).sum()
        correct = (logits.argmax(-1) == labels).float().sum()
        topk = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        top5 = (topk == labels[:, None]).any(-1).float().sum()
        count = torch.tensor(float(labels.shape[0]), device=logits.device)
        return {"loss_sum": loss, "correct": correct, "top5_correct": top5,
                "count": count}

    return eval_fn


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

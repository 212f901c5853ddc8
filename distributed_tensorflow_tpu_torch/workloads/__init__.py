"""Workload registry of the port: the five BASELINE.json configs as presets
(``mnist_mlp``, ``cifar10_cnn``, ``resnet50_imagenet``, ``bert_pretrain``,
``wide_deep``) and ``gpt_lm`` (causal LM, beyond the reference set), each
the JAX package's preset (the optimizers the JAX presets name that are
still missing, rmsprop, lamb and adafactor, are ROADMAP Queue A item
2.6).

Each workload module exposes ``default_config() -> RunConfig`` and
``build(cfg, device, mesh) -> WorkloadParts``; the shared runner
(``runner.py``) does the rest: ``run_workload`` trains,
``eval_workload`` evaluates the newest checkpoint without training.
Imported lazily, so importing the registry pulls no model."""

from __future__ import annotations

import importlib

from .runner import (  # noqa: F401
    RunConfig,
    RunResult,
    TrainSection,
    WorkloadParts,
    evaluate,
    evaluate_from_checkpoint,
    run,
)

_REGISTRY: dict[str, str] = {
    # name -> module (BASELINE.json:7-11 order)
    "mnist_mlp": ".mnist_mlp",
    "cifar10_cnn": ".cifar10_cnn",
    "resnet50_imagenet": ".resnet50_imagenet",
    "bert_pretrain": ".bert_pretrain",
    "wide_deep": ".wide_deep",
    # beyond the reference's five
    "gpt_lm": ".gpt_lm",
}


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str):
    """The workload module (``default_config``, ``build``)."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown workload '{name}'; available in the port: {available()}")
    return importlib.import_module(_REGISTRY[name], __package__)


def _config(name: str, overrides: list[str] | None):
    from ..utils import config as config_lib

    mod = get(name)
    cfg = mod.default_config()
    if overrides:
        cfg = config_lib.apply_overrides(cfg, overrides)
    return mod, cfg


def run_workload(name: str, overrides: list[str] | None = None, device="cuda",
                 **run_kwargs) -> RunResult:
    """Train workload ``name`` with ``--section.key=value`` overrides on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``)."""
    mod, cfg = _config(name, overrides)
    return run(cfg, mod.build, device=device, **run_kwargs)


def eval_workload(name: str, overrides: list[str] | None = None, device="cuda",
                  **eval_kwargs) -> dict:
    """Standalone eval from a checkpoint (the JAX package's
    ``eval_workload``; the reference evaluated from ``latest_checkpoint``):
    workload ``name`` built with ``--section.key=value`` overrides on
    ``device`` (the card by default), the newest checkpoint of
    ``--checkpoint.directory`` restored (``step=`` picks another) and
    ``train.eval_batches`` (or ``num_batches=``) of its eval stream
    evaluated, without training. Returns the metrics and the ``step``."""
    mod, cfg = _config(name, overrides)
    return evaluate_from_checkpoint(cfg, mod.build, device=device, **eval_kwargs)


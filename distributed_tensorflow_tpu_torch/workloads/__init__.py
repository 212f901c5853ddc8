"""Workload registry of the port: the five BASELINE.json configs as presets
(``mnist_mlp``, ``cifar10_cnn``, ``resnet50_imagenet``, ``bert_pretrain``,
``wide_deep``) and ``gpt_lm`` (causal LM, beyond the reference set, with
its ``long_context`` preset), each the JAX package's preset.

Each workload module exposes ``default_config() -> RunConfig`` and
``build(cfg, device, mesh) -> WorkloadParts`` (and may name other presets
in ``PRESETS``, picked by ``preset=``); the shared runner
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


def presets(name: str) -> list[str]:
    """The presets workload ``name`` offers besides its default."""
    return sorted(getattr(get(name), "PRESETS", {}))


def _config(name: str, overrides: list[str] | None, preset: str | None = None):
    from ..utils import config as config_lib

    mod = get(name)
    if preset is not None and preset not in presets(name):
        raise ValueError(f"workload {name!r} has no preset {preset!r}; it has "
                         f"{presets(name) or 'only its default'}")
    cfg = mod.PRESETS[preset]() if preset is not None else mod.default_config()
    if overrides:
        cfg = config_lib.apply_overrides(cfg, overrides)
    return mod, cfg


def run_workload(name: str, overrides: list[str] | None = None, device="cuda",
                 preset: str | None = None, **run_kwargs) -> RunResult:
    """Train workload ``name`` (its ``preset``, else its default config)
    with ``--section.key=value`` overrides on ``device`` (the card by
    default; raises without one unless ``device="cpu"``)."""
    mod, cfg = _config(name, overrides, preset)
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


"""Workload registry of the port: ``bert_pretrain``, ``gpt_lm`` and
``resnet50_imagenet`` so far (the other presets of the JAX package come
with their slices, ROADMAP Queue A)."""

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
    "bert_pretrain": ".bert_pretrain",
    "gpt_lm": ".gpt_lm",
    "resnet50_imagenet": ".resnet50_imagenet",
}


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str):
    """The workload module (``default_config``, ``build``)."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown workload '{name}'; available in the port: {available()}")
    return importlib.import_module(_REGISTRY[name], __package__)


def run_workload(name: str, overrides: list[str] | None = None, device="cuda",
                 **run_kwargs) -> RunResult:
    """Train workload ``name`` with ``--section.key=value`` overrides on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``)."""
    from ..utils import config as config_lib

    mod = get(name)
    cfg = mod.default_config()
    if overrides:
        cfg = config_lib.apply_overrides(cfg, overrides)
    return run(cfg, mod.build, device=device, **run_kwargs)

"""Goodput + MFU accounting — the subset of ``distributed_tensorflow_tpu/
obs/goodput.py`` the train loop needs, over the port's own registry:

- ``train_mfu``: THE one site of the ×3 training multiplier (model
  ``flops_per_example`` counts are forward-only);
- ``note_productive`` / ``note_wasted`` / ``goodput_fraction``: wall
  seconds of steps that advanced training against seconds lost, by
  cause. The port's loop has one cause so far, ``compile_warmup`` (the
  first steps: kernel builds, library handles); retries, restarts and
  resizes come with the resilience layer (ROADMAP Queue A).

Exported names (as in the JAX package): ``goodput_productive_seconds_total``
(counter), ``wasted_seconds_total{cause=...}`` (counter family),
``goodput_fraction`` and ``mfu`` (gauges).
"""

from __future__ import annotations

from .registry import Registry, default_registry

PRODUCTIVE_SECONDS = "goodput_productive_seconds_total"
WASTED_SECONDS = "wasted_seconds_total"
GOODPUT_FRACTION = "goodput_fraction"
MFU = "mfu"

WASTE_COMPILE_WARMUP = "compile_warmup"
WASTE_CAUSES = (WASTE_COMPILE_WARMUP,)


def _productive(reg: Registry):
    return reg.counter(
        PRODUCTIVE_SECONDS,
        "wall seconds spent in steps that advanced training")


def _wasted_total(reg: Registry) -> float:
    return sum(reg.counter(WASTED_SECONDS, "wall seconds lost, by cause", cause=c).value
               for c in WASTE_CAUSES)


def _refresh_fraction(reg: Registry) -> None:
    productive = _productive(reg).value
    total = productive + _wasted_total(reg)
    if total > 0:
        reg.gauge(GOODPUT_FRACTION,
                  "productive-step seconds / tracked wall seconds").set(productive / total)


def note_productive(seconds: float, registry: Registry | None = None) -> None:
    """Account ``seconds`` of wall-clock as productive training time and
    refresh the ``goodput_fraction`` gauge."""
    reg = registry if registry is not None else default_registry()
    _productive(reg).inc(max(float(seconds), 0.0))
    _refresh_fraction(reg)


def note_wasted(cause: str, seconds: float, registry: Registry | None = None) -> None:
    """Account ``seconds`` of wall-clock as wasted, bucketed by ``cause``
    (one of ``WASTE_CAUSES``)."""
    if cause not in WASTE_CAUSES:
        raise ValueError(f"unknown waste cause {cause!r} (known: {WASTE_CAUSES})")
    reg = registry if registry is not None else default_registry()
    reg.counter(WASTED_SECONDS, "wall seconds lost, by cause",
                cause=cause).inc(max(float(seconds), 0.0))
    _refresh_fraction(reg)


def goodput_fraction(registry: Registry | None = None) -> float:
    """Productive seconds over total tracked seconds (productive + every
    wasted bucket); nan when nothing has been tracked yet."""
    reg = registry if registry is not None else default_registry()
    productive = _productive(reg).value
    total = productive + _wasted_total(reg)
    return productive / total if total > 0 else float("nan")


def train_mfu(fwd_flops_per_step: float, steps_per_sec: float, n_chips: int | None = None,
              peak_per_chip: float | None = None,
              registry: Registry | None = None) -> float:
    """Training MFU from a FORWARD FLOP count — the single place the
    fwd+bwd multiplier is applied. ``n_chips`` defaults to the number of
    processes (one card each), ``peak_per_chip`` to the card's entry in
    ``utils.flops.PEAK_FLOPS_BY_KIND``. With ``registry`` the value is also
    published as the ``mfu`` gauge."""
    from ..parallel.cluster import process_count
    from ..utils import flops as flops_lib

    if n_chips is None:
        n_chips = process_count()
    if peak_per_chip is None:
        peak_per_chip = flops_lib.peak_flops_per_chip()
    value = flops_lib.mfu(
        fwd_flops_per_step * flops_lib.train_flops_multiplier(),
        steps_per_sec, n_chips, peak_per_chip)
    if registry is not None:
        registry.gauge(MFU, "model FLOPs utilization of the train step").set(value)
    return value

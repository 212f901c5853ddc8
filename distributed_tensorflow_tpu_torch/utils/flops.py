"""Analytic FLOPs + MFU accounting — the port's counterpart of
``distributed_tensorflow_tpu/utils/flops.py``.

MFU is computed from *analytic* model FLOPs (the model's own arithmetic
count, not profiler-counted device FLOPs). Every model's
``flops_per_example`` and every workload's ``flops_per_step`` are
FORWARD-only; the ×3 training multiplier is applied in exactly one
place, ``obs.goodput.train_mfu``.

The peak is keyed on the full ``torch.cuda.get_device_name()``, matched
exactly: the table holds the cards the port has run on, each at its own
published dense bf16 tensor-core rate. Any other name raises — the H100
PCIe and H100 NVL too, whose rates differ from the SXM card's — rather
than get another card's constant. "cpu" is a small constant for the
tests only.
"""

from __future__ import annotations

#: Peak dense bf16 FLOP/s per card (NVIDIA data sheets, without sparsity),
#: keyed by the exact device name.
PEAK_FLOPS_BY_KIND: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,  # the SXM card
    # tests on the CPU: arbitrary small constant so the MFU math runs
    "cpu": 1e12,
}


def peak_flops_per_chip(kind: str | None = None) -> float:
    """Peak dense bf16 FLOP/s of ``kind`` (default: the name of CUDA
    device 0). Raises for a card the table does not hold."""
    if kind is None:
        import torch

        kind = torch.cuda.get_device_name(0)
    if kind in PEAK_FLOPS_BY_KIND:
        return PEAK_FLOPS_BY_KIND[kind]
    raise KeyError(f"no peak FLOP/s for device {kind!r}; add its published dense "
                   f"bf16 rate to PEAK_FLOPS_BY_KIND")


def mfu(model_flops_per_step: float, steps_per_sec: float, n_chips: int,
        peak_per_chip: float | None = None) -> float:
    """model FLOPs/step × steps/s ÷ (chips × peak)."""
    if peak_per_chip is None:
        peak_per_chip = peak_flops_per_chip()
    return model_flops_per_step * steps_per_sec / (n_chips * peak_per_chip)


def dense_flops(m: int, n: int, k: int) -> float:
    """Forward FLOPs of an (m,k)@(k,n) matmul."""
    return 2.0 * m * n * k


def train_flops_multiplier() -> float:
    """fwd + bwd ≈ 3× fwd for dense nets (bwd does two matmuls per fwd one)."""
    return 3.0


def transformer_flops_per_token(n_params: float, seq_len: int,
                                n_layers: int, d_model: int) -> float:
    """Forward FLOPs/token ≈ 2·N_params + attention term 4·L·s·d (scores
    and AV, each 2·s·d per token; causal is counted full, as in the JAX
    package)."""
    return 2.0 * n_params + 4.0 * n_layers * seq_len * d_model

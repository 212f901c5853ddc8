"""Which backward a fused op runs — the port's counterpart of
``resolve_bwd_impl`` in ``distributed_tensorflow_tpu/ops/_tiling.py``.

``resolve_bwd_impl(bwd_impl)``: an explicit argument wins, else the
``DTF_FUSED_BWD`` environment variable, else ``"xla"``. The two values
are the JAX package's:

- ``"xla"``: the plain-math backward. The JAX package leaves its two
  products (dgrad ``g @ w^T`` and wgrad ``h^T @ g``) to XLA outside
  Pallas; the port leaves them to ``torch.mm`` (cuBLAS on the card), with
  the elementwise prologue, mask and reductions in plain PyTorch.
- ``"pallas"``: the hand-written backward kernels (``csrc/*.cu``).

The ``"xla"`` default is the JAX package's, which was measured on a TPU;
the port keeps it until its own card times say otherwise (PERF.md).

The rest of ``_tiling.py`` describes a TPU compiler (VMEM budgets,
sublane padding, the ``PALLAS_BWD_KNOWN_SLOW`` shape guard that turns
``"pallas"`` back into ``"xla"``) and is not copied: a kernel of the port
runs at every shape it accepts, or raises. Each op family states its own
kernel-choice rule beside its kernels (``fused_conv_bn.single_pass``).
"""

from __future__ import annotations

import os

import torch

BWD_IMPLS = ("xla", "pallas")


def resolve_bwd_impl(bwd_impl: str | None = None) -> str:
    """``bwd_impl``, else ``$DTF_FUSED_BWD``, else ``"xla"``; raises on
    any other value."""
    impl = bwd_impl or os.environ.get("DTF_FUSED_BWD", "xla")
    if impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be 'xla' or 'pallas', got {impl!r}")
    return impl


def mm_exact(a, b):
    """f32 product of the operands as they are (exact products of bf16):
    the kernels' plain versions multiply this way."""
    return torch.matmul(a.float(), b.float())


def mm_library(a, b):
    """The ``"xla"`` backward's products: on the card a bf16 ``torch.mm``
    with an f32 result (cuBLAS, as XLA's ``preferred_element_type=f32``);
    anything else multiplies in f32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return mm_exact(a, b)

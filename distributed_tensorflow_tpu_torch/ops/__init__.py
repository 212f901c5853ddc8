"""Ops of the ported serve path. The two CUDA kernels (``csrc/``) are
built on their first launch, never at import (``_build.py``)."""

from .attention import (  # noqa: F401
    NEG_INF,
    cached_attention,
    paged_append_kv,
    paged_attention,
    paged_gather_kv,
)
from .fused_ln_matmul import ln_matmul, ln_matmul_plain  # noqa: F401
from .paged_attention import (  # noqa: F401
    paged_attention_plain,
    paged_flash_attention,
)

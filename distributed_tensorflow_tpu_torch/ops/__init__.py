"""Ops of the ported serve and training paths. The CUDA kernels
(``csrc/``) are built on their first launch, never at import
(``_build.py``); ``embedding`` (Wide&Deep's sharded lookups) launches
none of its own. The dispatch ``attention.attention`` and the
differentiable ``flash_attention.flash_attention`` are not re-exported
here: their names are their modules'."""

from .attention import (  # noqa: F401
    NEG_INF,
    attention_reference,
    cached_attention,
    paged_append_kv,
    paged_attention,
    paged_gather_kv,
)
from .flash_attention import (  # noqa: F401
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from .fused_conv_bn import (  # noqa: F401
    bn_scale_shift,
    conv1x1_bn_act,
    conv1x1_bn_act_plain,
    conv1x1_bn_bwd_dw,
    conv1x1_bn_bwd_dx,
    conv1x1_bn_bwd_plain,
    conv1x1_bn_bwd_single,
    conv1x1_bn_fwd,
    moments_from_sums,
)
from .fused_ln_matmul import (  # noqa: F401
    ln_matmul,
    ln_matmul_bwd_dw,
    ln_matmul_bwd_dx,
    ln_matmul_bwd_plain,
    ln_matmul_plain,
)
from .paged_attention import (  # noqa: F401
    paged_attention_plain,
    paged_flash_attention,
)

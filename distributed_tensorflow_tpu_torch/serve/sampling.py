"""Token sampling: greedy / temperature / top-k, plus the speculative
accept/reject rule.

Counterpart of ``distributed_tensorflow_tpu/serve/sampling.py``.
``sample`` draws from a ``torch.Generator`` where the JAX version splits
a ``jax.random`` key, so temperature sampling gives other tokens than
JAX's for the same seed; greedy (``temperature <= 0``) is argmax and
equal. The ``spec_verify_*`` pair is host numpy in both packages and is
copied as it is: greedy acceptance is exact (the emitted stream equals
non-speculative greedy decode); temperature acceptance is the
speculative-sampling rule for a deterministic drafter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import NEG_INF


def sample(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:
    """logits [..., V] → token ids [...] (int32), on logits' device."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1]).to(torch.int32)


def spec_verify_greedy(
    logits: np.ndarray, draft: list[int] | tuple[int, ...]
) -> tuple[list[int], int]:
    """Greedy-exact acceptance. ``logits`` [len(draft)+1, V] — the
    target's logits at each drafted position plus one past the last
    draft; row ``i`` conditions on the drafts before it, so it is only
    meaningful while every earlier draft was accepted. Returns
    ``(emitted, accepted)``: the argmax at each position up to and
    including the first mismatch (the mismatch row's argmax IS the
    correction token), plus the bonus token when every draft survives —
    always ``accepted + 1`` tokens, never zero, which is why a verify
    step can never be slower than a plain decode step in tokens."""
    arg = np.argmax(np.asarray(logits), axis=-1)
    emitted: list[int] = []
    accepted = 0
    for i, d in enumerate(draft):
        tok = int(arg[i])
        emitted.append(tok)
        if tok != int(d):
            return emitted, accepted
        accepted += 1
    emitted.append(int(arg[len(draft)]))
    return emitted, accepted


def spec_verify_sample(
    logits: np.ndarray,
    draft: list[int] | tuple[int, ...],
    gen: np.random.Generator,
    *,
    temperature: float,
    top_k: int = 0,
) -> tuple[list[int], int]:
    """Distribution-preserving acceptance for a deterministic drafter.
    Draft ``d_i`` is accepted with probability ``p_i(d_i)`` (``p_i`` the
    target's temperature/top-k distribution at that position — the
    draft's distribution is a point mass, so the min(1, p/q) rule
    reduces to this); on rejection the emitted token is drawn from the
    renormalized residual (``p_i`` with ``d_i`` zeroed) and verification
    stops. If every draft survives, the bonus token is drawn from the
    last row unmodified. The marginal of each emitted token equals
    straight temperature sampling."""
    if temperature <= 0.0:
        raise ValueError("spec_verify_sample requires temperature > 0; "
                         "use spec_verify_greedy")
    scaled = np.asarray(logits, np.float64) / temperature
    if top_k > 0:
        kth = -np.sort(-scaled, axis=-1)[:, top_k - 1: top_k]
        scaled = np.where(scaled < kth, NEG_INF, scaled)
    scaled = scaled - scaled.max(axis=-1, keepdims=True)
    p = np.exp(scaled)
    p /= p.sum(axis=-1, keepdims=True)
    emitted: list[int] = []
    accepted = 0
    for i, d in enumerate(draft):
        d = int(d)
        if gen.random() < p[i, d]:
            emitted.append(d)
            accepted += 1
            continue
        residual = p[i].copy()
        residual[d] = 0.0
        total = residual.sum()
        if total <= 0.0:  # the draft held ALL the mass; nothing to resample
            emitted.append(d)
            accepted += 1
            continue
        emitted.append(int(gen.choice(residual.shape[0], p=residual / total)))
        return emitted, accepted
    emitted.append(int(gen.choice(p.shape[-1], p=p[len(draft)])))
    return emitted, accepted

"""The port's ServeEngine against the JAX package's, in lock-step, on the
same converted tiny weights (torch_port_helpers.params_np: scaled so the
greedy streams vary — at flax's normal(0.02) init they only repeat the
last prompt token) and the same request sequences:

- a shared system prefix (prefix reuse) and a repeated prompt (COW);
- a pool small enough to force preemption;
- n-gram speculative decoding (``spec_k=4``).

After EVERY step: the same delivered tokens, the logits of every step
function call within atol = rtol = 1e-4 (f32, other summation order),
and the same host state — allocator free list, refcounts, generations,
prefix cache, COW and eviction counts, block tables, write indices,
pending prefills, queue and slots. A token that differs is accepted only
where the JAX logits had a top-2 margin below that tolerance (a near
tie), and ends the comparison. No block leaks after ``drain()``.
"""

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu_torch import serve as tserve
from distributed_tensorflow_tpu_torch.weights import from_jax_params

TOL = 1e-4


def _state(eng):
    a = eng.alloc
    return dict(
        free=list(a._free), ref=list(a._ref), gen=list(a._gen),
        prefix=list(a._prefix.items()),
        partial=sorted((k, sorted(v)) for k, v in a._partial.items()),
        evictions=a.evictions, cow=a.cow_copies,
        blocks=[list(b) for b in eng._blocks], table=eng._table.tolist(),
        written=eng._written.tolist(), last=eng._last.tolist(),
        pending=dict(eng._pending),
        queue=[r.uid for r in eng.sched.queue],
        slots=[None if r is None else (r.uid, list(r.generated), r.preemptions)
               for r in eng.sched.slots],
        finished=sorted(eng.sched.finished),
    )


def _record(eng, names, log):
    for name in names:
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn):
            logits, cache = _fn(*a)
            log.append(np.asarray(logits.detach() if torch.is_tensor(logits) else logits,
                                  dtype=np.float32))
            return logits, cache
        setattr(eng, name, wrapped)


class Pair:
    """A JAX engine and a port engine driven with the same calls."""

    def __init__(self, jcfg, params, **kw):
        self.j = jserve.ServeEngine(jcfg, params, **kw)
        self.t = tserve.ServeEngine(
            H.port_cfg(jcfg), from_jax_params(params, H.port_cfg(jcfg), device="cpu"),
            device="cpu", **kw)
        names = ["_prefill_chunk_fn", "_decode"] + (["_verify"] if kw.get("spec_k") else [])
        self.jl, self.tl = [], []
        _record(self.j, names, self.jl)
        _record(self.t, names, self.tl)
        self.tokens: list[tuple[int, int]] = []
        self.near_tie = False

    def submit(self, prompt, max_new):
        uid = self.j.submit(prompt, max_new_tokens=max_new)
        assert self.t.submit(prompt, max_new_tokens=max_new) == uid
        return uid

    def step(self):
        js, ts = self.j.step(), self.t.step()
        assert len(self.jl) == len(self.tl)
        margins = []
        for jl, tl in zip(self.jl, self.tl):
            assert tl.shape == jl.shape
            np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
            top2 = -np.sort(-jl.reshape(-1, jl.shape[-1]), axis=-1)[:, :2]
            margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        self.jl.clear()
        self.tl.clear()
        if js.tokens != ts.tokens:
            assert min(margins) < TOL, (
                f"token streams differ away from a near tie: {js.tokens} vs {ts.tokens}")
            self.near_tie = True
            return
        self.tokens += js.tokens
        assert (js.admitted, js.decoded_slots, js.prefill_chunks, js.finished) == \
            (ts.admitted, ts.decoded_slots, ts.prefill_chunks, ts.finished)
        assert _state(self.j) == _state(self.t)

    def run(self):
        while self.j.sched.has_work and not self.near_tie:
            self.step()

    def finish(self):
        """Drain both; no leaked blocks; returns uid -> generated."""
        self.run()
        jd, td = self.j.drain(), self.t.drain()
        for eng in (self.j, self.t):
            assert eng.alloc.blocks_free == eng.cache.num_blocks
        if not self.near_tie:
            assert {u: r.generated for u, r in jd.items()} == \
                {u: r.generated for u, r in td.items()}
        return {u: r for u, r in td.items()}


@pytest.fixture(scope="module")
def model():
    jcfg = H.jax_cfg(vocab_size=128, max_len=48)
    return jcfg, H.params_np(jcfg, seed=0)


def _varied(done) -> bool:
    """The streams are not the init's degenerate repeat of one token."""
    return any(len(set(r.generated)) > 3 for r in done.values())


def test_serve_prefix_reuse_and_cow_lockstep(model):
    jcfg, params = model
    p = Pair(jcfg, params, num_slots=4, block_size=8, prefill_chunk=8)
    rng = np.random.default_rng(5)
    system = rng.integers(1, 128, size=20).tolist()
    p.submit(system + [50], 6)
    p.run()  # the warm request registers the shared prefix
    for i in range(3):
        p.submit(system + rng.integers(1, 128, size=3 + i).tolist(), 8)
    repeat = rng.integers(1, 128, size=13).tolist()  # 1 full block + a 5-token tail
    p.submit(repeat, 10)
    p.step(), p.step(), p.step()  # prefilled + registered, mid-decode
    p.submit(repeat, 10)          # maps the tail block: copy-on-write
    done = p.finish()
    assert p.near_tie or (p.t.alloc.cow_copies >= 1
                          and p.t.registry.get("prefix_reuse_hits_total").value > 0)
    assert _varied(done)


def test_serve_preemption_lockstep(model):
    jcfg, params = model
    p = Pair(jcfg, params, num_slots=2, block_size=8, prefill_chunk=8, max_len=32,
             num_blocks=5, prefix_reuse=False)
    for i in range(3):
        p.submit([10 + i] * 6 + [3, 1, 4, 1], 18)
    done = p.finish()
    assert p.near_tie or sum(r.preemptions for r in done.values()) > 0
    assert _varied(done)


def test_serve_speculative_lockstep(model):
    """Drafts accepted and rejected: the second request's prompt holds
    the first one's prompt and greedy continuation, so the n-gram
    drafter has something to find."""
    jcfg, params = model
    p = Pair(jcfg, params, num_slots=2, block_size=8, prefill_chunk=8, spec_k=4)
    rng = np.random.default_rng(9)
    first = rng.integers(1, 128, size=6).tolist()
    uid = p.submit(first, 12)
    p.submit(rng.integers(1, 128, size=9).tolist(), 12)
    p.run()
    cont = [tok for u, tok in p.tokens if u == uid]
    p.submit(first + cont + first, 12)
    done = p.finish()
    reg = p.t.registry
    assert p.near_tie or 0 < reg.get("spec_tokens_accepted_total").value \
        < reg.get("spec_tokens_proposed_total").value
    assert _varied(done)

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, needs one CUDA card,
and exits non-zero — printing no result line — when there is none, when
the port cannot be imported (e.g. the script alone in a directory), or
when any phase fails:

1. build both kernels from ``distributed_tensorflow_tpu_torch/ops/csrc``
   (one nvcc per source, started together) and print ptxas's report;
2. hold each kernel against its plain PyTorch version on the card at the
   serve path's shapes (gpt_small: H=12, D=64, bs=16; d=768), with the
   tolerances stated in ``TOL``; time kernel, plain version, one library
   call and the bound with CUDA events;
3. serve 8 requests through ``gpt_small`` at full width (bf16, random
   weights from seed 0, 4 slots, block_size 16, prefill_chunk 64, a
   shared 128-token system prefix on four prompts, max_new 32, greedy)
   three times — plain decode, ``spec_k=4``, ``fused_ln_matmul=True`` —
   counting kernel launches and checking that drain() frees every block;
4. rerun the plain-decode pass with no kernel on the path
   (``paged_impl="gather"``, ``fused_ln_matmul=False``) and hold both
   kernel passes against it: the logits behind every delivered token
   within ``TOL["logits"]``, greedy streams equal (a stream may diverge
   only where the reference's top-2 logit margin is below that
   tolerance);
5. print the ``kernels`` JSON line, then the ``ok`` line last.

TF32 is off for every f32 product compared here
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense tensor-core bf16
            "float32": 67e12}       # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

#: stated tolerances (atol, rtol) and why
TOL = {
    # same f32 arithmetic, other summation order over up to 1024 keys /
    # 768 features
    "paged_attention/float32": (5e-5, 5e-5),
    "ln_matmul/float32": (1e-4, 1e-4),
    # both versions round one f32 result to bf16 at the end (and
    # ln_matmul its normalised rows), so they may differ by one bf16 ulp:
    # 2^-8 relative
    "paged_attention/bfloat16": (1e-2, 2 ** -7),
    "ln_matmul/bfloat16": (1e-2, 2 ** -7),
    # f32 logits of the bf16 model, kernel path vs the gather path with no
    # kernel: one-ulp bf16 differences in attention / LN+matmul outputs,
    # carried through 12 residual layers (logits of random weights have
    # std ~0.5)
    "logits": 5e-2,
}

REPO = os.path.dirname(os.path.abspath(__file__))

#: where the tensors go (a rehearsal on the CPU may point this elsewhere)
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fns, iters: int = 50, warmup: int = 5) -> dict:
    """Time one call, cycling through ``fns`` (closures over independent
    input sets, together larger than L2, so each call finds its inputs
    cold as the serve path does). Returns ``device_ms``: the device time
    of every kernel the calls launched, per call, from ``torch.profiler``
    (CUPTI; the fullest of three traces) — the kernel's own time, free of
    the Python wrapper's host overhead; and ``call_ms``: CUDA events around the back-to-back calls,
    per call, which includes the host time between launches whenever
    that exceeds the device time."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    stop.record()
    stop.synchronize()
    call_ms = start.elapsed_time(stop) / iters
    act = torch.profiler.ProfilerActivity
    traces = []
    for _ in range(3):  # CUPTI now and then drops records: keep the fullest trace
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        traces.append(sum(e.self_device_time_total for e in device_events(torch, prof)))
    if max(traces) <= 0:
        raise SmokeFailure("torch.profiler recorded no device time in 3 traces")
    return {"device_ms": max(traces) / 1e3 / iters, "call_ms": call_ms}


def device_events(torch, prof):
    """The profiler's device-side entries (kernels, copies, memsets).
    The CPU-side operator entries carry their kernels' device time too,
    so summing every entry would count it twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda]


def copies_for(nbytes: int) -> int:
    """Input sets to cycle so that together they exceed twice the L2."""
    return max(1, -(-2 * L2_BYTES // max(nbytes, 1)))


def check_close(torch, name, got, want, tol) -> float:
    atol, rtol = tol
    if not torch.isfinite(got.float()).all():
        raise SmokeFailure(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = float((err / want.float().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={rel:.3e} "
        f"tol=(atol {atol:g}, rtol {rtol:g}) {'OK' if not bad else f'{bad} FAIL'}")
    if bad:
        raise SmokeFailure(f"{name}: {bad} elements outside tolerance")
    return max_abs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_case(torch, np, rng, kind, dtype, H=12, D=64, bs=16, MB=64):
    """Inputs for one paged-attention case. Tables are non-contiguous
    random block ids with sentinel tails; the cases carry an idle row
    (all-sentinel table, past-the-table q_pos) and padded rows
    (q_pos = -1) as the serve path and the JAX tests do."""
    oob = MB * bs
    if kind == "decode":            # B=8 slots, S=1, ragged contexts 1..1000
        B, S = 8, 1
        ctx = rng.integers(1, 1001, size=B)
        ctx[0], ctx[1] = 1000, 1
        rows = [("live", [c - 1]) for c in ctx[:6]] + [("idle", None), ("live", [-1])]
        nblk = [-(-int(c) // bs) for c in ctx[:6]] + [0, 4]
    elif kind == "prefill":         # one chunk of 64 at positions 500..553, 10 padded
        B, S = 1, 64
        pos = list(range(500, 554)) + [-1] * 10
        rows = [("live", pos)]
        nblk = [-(-554 // bs)]
    else:                           # verify: 4 slots, S = K+1 = 5
        B, S = 4, 5
        rows = [("live", list(range(300, 305))), ("live", list(range(17, 20)) + [oob, oob]),
                ("idle", None), ("live", list(range(990, 995)))]
        nblk = [-(-305 // bs), 2, 0, -(-995 // bs)]
    NB = sum(nblk) + 8
    perm = rng.permutation(NB)
    table = np.full((B, MB), NB, np.int32)
    q_pos = np.full((B, S), oob, np.int32)
    used = 0
    for b, ((state, pos), n) in enumerate(zip(rows, nblk)):
        table[b, :n] = perm[used: used + n]
        used += n
        if state == "live":
            q_pos[b, :len(pos)] = pos
    dev = DEVICE
    mk = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
    return dict(q=mk(B, H, S, D), k_pool=mk(NB, H, bs, D), v_pool=mk(NB, H, bs, D),
                block_table=torch.from_numpy(table).to(dev),
                q_pos=torch.from_numpy(q_pos).to(dev))


def paged_bound_ms(case, dtype_name) -> tuple[float, str]:
    """Least time for the work these inputs need: K/V of every attended
    position read once, q/table/positions read and the output written
    once; 4*D operations per (query, attended key) pair per head."""
    q, kp = case["q"], case["k_pool"]
    B, H, S, D = q.shape
    bs = kp.shape[2]
    MB = case["block_table"].shape[1]
    pos = case["q_pos"].long().cpu()
    attended = (pos + 1).clamp(0, MB * bs)            # [B,S]
    ctx = attended.max(dim=1).values                  # positions row b reads
    esz = q.element_size()
    nbytes = (2 * H * int(ctx.sum()) * D * esz + 2 * q.numel() * esz
              + case["block_table"].numel() * 4 + case["q_pos"].numel() * 4)
    ops = 4 * H * D * int(attended.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ln_case(torch, np, rng, M, d, n, dtype, linear_layout=True):
    dev = DEVICE
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev)
    w_nd = (0.02 * f(n, d)).to(dtype)  # nn.Linear weight [n, d]
    return dict(x=f(M, d).to(dtype), gamma=1 + 0.1 * f(d), beta=0.1 * f(d),
                w=w_nd.t() if linear_layout else w_nd.t().contiguous(),
                bias=0.02 * f(n))


def ln_bound_ms(c, dtype_name) -> tuple[float, str]:
    M, d = c["x"].shape
    n = c["w"].shape[1]
    esz = c["x"].element_size()
    nbytes = esz * (M * d + d * n + M * n) + 4 * (2 * d + n)
    ops = 2 * M * d * n + 8 * M * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(torch, np, F):
    from distributed_tensorflow_tpu_torch.ops import attention as att
    from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import (
        ln_matmul, ln_matmul_plain)
    from distributed_tensorflow_tpu_torch.ops.paged_attention import (
        paged_attention_plain, paged_flash_attention)

    rng = np.random.default_rng(0)
    results = {"paged_attention": {"err": 0.0, "rows": []},
               "ln_matmul": {"err": 0.0, "rows": []}}
    log("tolerances (atol, rtol): f32 kernel vs plain — same f32 math in another "
        "summation order; bf16 — both round one f32 result (ln_matmul also its "
        "normalised rows) to bf16, so they may differ by one bf16 ulp (2^-8 "
        f"relative): {TOL}")
    log("phase 2a: paged attention kernel vs plain version "
        "(H=12, D=64, bs=16, MB=64)")
    for kind in ("decode", "prefill", "verify"):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            c = paged_case(torch, np, rng, kind, dtype)
            kw = dict(q_pos=c["q_pos"])
            args = (c["q"], c["k_pool"], c["v_pool"], c["block_table"])
            got = paged_flash_attention(*args, **kw)
            want = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            name = f"paged_attention/{kind}/{dn} B={c['q'].shape[0]} S={c['q'].shape[2]}"
            err = check_close(torch, name, got, want, TOL[f"paged_attention/{dn}"])
            results["paged_attention"]["err"] = max(results["paged_attention"]["err"], err)
            if dtype != torch.bfloat16:
                continue
            # timing on cold inputs: independent copies of the pools
            nbytes = 2 * c["k_pool"].numel() * c["k_pool"].element_size()
            sets = [c] + [dict(c, k_pool=c["k_pool"].clone(), v_pool=c["v_pool"].clone())
                          for _ in range(copies_for(nbytes) - 1)]
            kern = [lambda s=s: paged_flash_attention(
                s["q"], s["k_pool"], s["v_pool"], s["block_table"], q_pos=s["q_pos"])
                for s in sets]
            plain = [lambda s=s: paged_attention_plain(
                s["q"], s["k_pool"], s["v_pool"], s["block_table"], q_pos=s["q_pos"])
                for s in sets]
            # library yardstick: SDPA over the gathered K/V, timed only
            lib_in = []
            for s in sets:
                kg = att.paged_gather_kv(s["k_pool"], s["block_table"])
                vg = att.paged_gather_kv(s["v_pool"], s["block_table"])
                M = kg.shape[2]
                mask = (torch.arange(M, device=DEVICE)[None, None, :]
                        <= s["q_pos"].long()[:, :, None])[:, None]
                lib_in.append((s["q"], kg, vg, mask))
            lib = [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
                   for a in lib_in]
            before = paged_flash_attention.launches
            tk, tp, tl = (cuda_ms(torch, f) for f in (kern, plain, lib))
            row = dict(case=kind, B=c["q"].shape[0], S=c["q"].shape[2],
                       ms=tk["device_ms"], plain_ms=tp["device_ms"],
                       library_ms=tl["device_ms"], call_ms=tk["call_ms"])
            paged_flash_attention.launches = before  # comparison launches do not count
            row["bound_ms"], row["bound_by"] = paged_bound_ms(c, dn)
            results["paged_attention"]["rows"].append(row)
            log(f"    {kind} bf16: kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                f"library_ms={row['library_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
                f"({row['bound_by']}); wrapper call_ms={row['call_ms']:.4f}")

    # how the time grows with the context: one batch row (12 heads) at
    # 128 keys and at 1024
    step_ms = []
    for ctx in (128, 1024):
        c = paged_case(torch, np, rng, "decode", torch.bfloat16)
        c["q"], c["block_table"] = c["q"][:1], c["block_table"][:1]
        c["q_pos"] = torch.full((1, 1), ctx - 1, dtype=torch.int32, device=DEVICE)
        c["block_table"][0, :ctx // 16] = torch.arange(ctx // 16, device=DEVICE)
        before = paged_flash_attention.launches
        step_ms.append(cuda_ms(torch, [lambda c=c: paged_flash_attention(
            c["q"], c["k_pool"], c["v_pool"], c["block_table"], q_pos=c["q_pos"])])["device_ms"])
        paged_flash_attention.launches = before
    log(f"    one batch row, context 128 vs 1024 keys: {step_ms[0]:.5f} vs "
        f"{step_ms[1]:.5f} ms")

    log("phase 2b: ln_matmul kernel vs plain version (d=768)")
    for n in (768, 3072):
        for M in (8, 64, 40):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                for linear_layout in ((True, False) if dtype == torch.bfloat16 else (True,)):
                    c = ln_case(torch, np, rng, M, 768, n, dtype, linear_layout)
                    got = ln_matmul(c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
                    want = ln_matmul_plain(c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
                    torch.cuda.synchronize()
                    lay = "w=linear.weight.t()" if linear_layout else "w contiguous [d,n]"
                    err = check_close(torch, f"ln_matmul/{dn} M={M} n={n} {lay}", got,
                                      want, TOL[f"ln_matmul/{dn}"])
                    results["ln_matmul"]["err"] = max(results["ln_matmul"]["err"], err)
                if dtype != torch.bfloat16:
                    continue
                nbytes = c["w"].numel() * c["w"].element_size()
                sets = [ln_case(torch, np, rng, M, 768, n, dtype)
                        for _ in range(copies_for(nbytes))]
                kern = [lambda s=s: ln_matmul(s["x"], s["gamma"], s["beta"], s["w"], s["bias"])
                        for s in sets]
                plain = [lambda s=s: ln_matmul_plain(s["x"], s["gamma"], s["beta"], s["w"],
                                                     s["bias"]) for s in sets]
                lib_in = [(s["x"], s["gamma"].to(dtype), s["beta"].to(dtype),
                           s["w"].t(), s["bias"].to(dtype)) for s in sets]
                lib = [lambda a=a: F.linear(F.layer_norm(a[0], (768,), a[1], a[2], 1e-6),
                                            a[3], a[4]) for a in lib_in]
                before = ln_matmul.launches
                tk, tp, tl = (cuda_ms(torch, f) for f in (kern, plain, lib))
                row = dict(M=M, n=n, ms=tk["device_ms"], plain_ms=tp["device_ms"],
                           library_ms=tl["device_ms"], call_ms=tk["call_ms"])
                ln_matmul.launches = before
                row["bound_ms"], row["bound_by"] = ln_bound_ms(sets[0], dn)
                results["ln_matmul"]["rows"].append(row)
                log(f"    M={M} n={n} bf16: kernel_ms={row['ms']:.5f} "
                    f"plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
                    f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}); "
                    f"wrapper call_ms={row['call_ms']:.4f}")
    return results


# ---------------------------------------------------------------------------
# phases 3-4: serve gpt_small at full width
# ---------------------------------------------------------------------------


def make_prompts(np, vocab: int, n: int = 8, seed: int = 0):
    """8 prompts of 48..900 tokens from a seeded generator; four open
    with the same 128-token system prefix (prefix reuse), and the last of
    those repeats another one whole (copy-on-write)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=128).tolist()
    lens = rng.integers(48, 901, size=n)
    lens[0], lens[1] = 900, 48
    prompts = []
    for i, L in enumerate(lens):
        if i % 2 == 0:
            L = max(int(L), 160)
            prompts.append(system + rng.integers(0, vocab, size=L - 128).tolist())
        else:
            prompts.append(rng.integers(0, vocab, size=int(L)).tolist())
    # a repeated prompt maps every block of the first, including the one
    # holding its last position, which it must rewrite: copy-on-write
    prompts[6] = list(prompts[4])
    return prompts


def serve_pass(torch, np, cfg, params, prompts, label, *, record=False, **kw):
    """One engine run over ``prompts``; returns streams, stats and (with
    ``record``) the logits row behind every delivered token."""
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, device=DEVICE, num_slots=4, block_size=16,
                      prefill_chunk=64, seed=0, **kw)
    rows: dict[tuple[int, int], object] = {}
    if record:
        last = {}
        pre, dec, app = eng._prefill_chunk_fn, eng._decode, eng.sched.append_token

        def prefill(*a):
            logits, cache = pre(*a)
            last["src"] = ("prefill", logits)
            return logits, cache

        def decode(*a):
            logits, cache = dec(*a)
            last["src"] = ("decode", logits)
            return logits, cache

        def append_token(slot, token):
            req = eng.sched.slots[slot]
            kind, logits = last["src"]
            rows[(req.uid, len(req.generated))] = (
                logits if kind == "prefill" else logits[slot]).float().clone()
            return app(slot, token)

        eng._prefill_chunk_fn, eng._decode = prefill, decode
        eng.sched.append_token = append_token
    uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.sched.has_work:
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = eng.drain()
    streams = {u: list(done[u].generated) for u in uids}
    reg = eng.registry
    ntok = sum(len(s) for s in streams.values())
    ttft = [r.t_first_token - r.t_submit for r in done.values()]
    tpot = [(r.t_finish - r.t_first_token) / max(len(r.generated) - 1, 1)
            for r in done.values()]
    out = dict(label=label, streams=streams, rows=rows, steps=steps, wall_s=wall,
               tokens=ntok, tok_s=ntok / wall,
               ttft_p50_ms=1e3 * float(np.median(ttft)),
               tpot_p50_ms=1e3 * float(np.median(tpot)),
               ttft_p50_bucket_ms=1e3 * reg.get("serve_ttft_seconds").percentile(0.5),
               reuse_hits=int(reg.get("prefix_reuse_hits_total").value),
               cow_copies=eng.alloc.cow_copies,
               preemptions=sum(r.preemptions for r in done.values()),
               spec_rate=reg.get("spec_acceptance_rate").value,
               blocks_free=eng.alloc.blocks_free, num_blocks=eng.cache.num_blocks)
    if out["blocks_free"] != out["num_blocks"]:
        raise SmokeFailure(f"{label}: block leak after drain(): "
                           f"{out['blocks_free']} of {out['num_blocks']} free")
    if any(len(s) != 32 for s in streams.values()):
        raise SmokeFailure(f"{label}: a stream did not reach max_new=32")
    return out


def compare_passes(torch, got, ref, tol):
    """Logits behind each delivered token within ``tol``; greedy streams
    equal, or diverging only at a reference top-2 margin below ``tol``."""
    worst, diverged = 0.0, []
    for uid, ref_stream in ref["streams"].items():
        stream = got["streams"][uid]
        for t, (a, b) in enumerate(zip(stream, ref_stream)):
            ra, rb = got["rows"][(uid, t)], ref["rows"][(uid, t)]
            if not torch.isfinite(ra).all():
                raise SmokeFailure(f"{got['label']}: non-finite logits (uid {uid}, token {t})")
            worst = max(worst, float((ra - rb).abs().max()))
            if a != b:
                top2 = torch.topk(rb, 2).values
                margin = float(top2[0] - top2[1])
                diverged.append((uid, t, margin))
                if margin >= tol:
                    raise SmokeFailure(
                        f"{got['label']}: uid {uid} diverges at token {t} with reference "
                        f"top-2 margin {margin:.4f} >= tol {tol}")
                break  # conditioning differs from here on
    log(f"  {got['label']} vs {ref['label']}: max |logits diff| = {worst:.4e} "
        f"(tol {tol}); streams equal {len(ref['streams']) - len(diverged)}/"
        f"{len(ref['streams'])}; divergences (uid, token, margin) {diverged}")
    if worst > tol:
        raise SmokeFailure(f"{got['label']}: logits differ by {worst} > {tol}")
    return worst


def phase_serve(torch, np, card):
    import dataclasses

    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import ln_matmul
    from distributed_tensorflow_tpu_torch.ops.paged_attention import paged_flash_attention

    cfg = tfm.gpt_small()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"phase 3: gpt_small (L={cfg.num_layers} d={cfg.d_model} H={cfg.num_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}), random weights "
        f"from seed 0 in {time.perf_counter() - t0:.2f}s; 4 slots, block_size 16, "
        f"prefill_chunk 64, 8 requests, max_new 32, greedy; on {card}")
    prompts = make_prompts(np, cfg.vocab_size)
    log(f"  prompt lengths {[len(p) for p in prompts]}")
    # warm-up: one short request per configuration (cuBLAS handles, caches)
    for kw in ({}, {"spec_k": 4}):
        from distributed_tensorflow_tpu_torch.serve import ServeEngine
        w = ServeEngine(dataclasses.replace(cfg, fused_ln_matmul=True), params,
                        device=DEVICE, num_slots=4, prefill_chunk=64, **kw)
        w.submit(prompts[1][:40], max_new_tokens=4)
        w.run()
    torch.cuda.synchronize()

    passes, counts = {}, {}
    paged_flash_attention.launches = ln_matmul.launches = 0  # main path starts
    for label, c, kw in (("spec_k=0", cfg, {}),
                         ("spec_k=4", cfg, {"spec_k": 4}),
                         ("fused_ln_matmul", dataclasses.replace(cfg, fused_ln_matmul=True), {})):
        a0, l0 = paged_flash_attention.launches, ln_matmul.launches
        passes[label] = serve_pass(torch, np, c, params, prompts, label,
                                   record=label != "spec_k=4", **kw)
        p = passes[label]
        counts[label] = (paged_flash_attention.launches - a0, ln_matmul.launches - l0)
        log(f"  {label}: {p['tokens']} tokens in {p['wall_s']:.3f}s = {p['tok_s']:.1f} tok/s, "
            f"TTFT p50 {p['ttft_p50_ms']:.2f} ms (registry bucket {p['ttft_p50_bucket_ms']:.0f}), "
            f"TPOT p50 {p['tpot_p50_ms']:.3f} ms, "
            f"{p['steps']} steps, launches paged_attention={counts[label][0]} "
            f"ln_matmul={counts[label][1]}, reuse_hits={p['reuse_hits']} "
            f"cow_copies={p['cow_copies']} preemptions={p['preemptions']} "
            f"spec_acceptance={p['spec_rate']:.3f} blocks_free={p['blocks_free']}/"
            f"{p['num_blocks']}")
    launches = {"paged_attention": paged_flash_attention.launches,
                "ln_matmul": ln_matmul.launches}  # main path read
    if min(launches.values()) < 1 or counts["fused_ln_matmul"][1] < 1 \
            or min(c[0] for c in counts.values()) < 1:
        raise SmokeFailure(f"a kernel of the path never launched: {counts}")
    if passes["spec_k=0"]["reuse_hits"] < 1 or passes["spec_k=0"]["cow_copies"] < 1:
        raise SmokeFailure("the shared prefix was never reused or never copied on write")
    same = sum(passes["spec_k=4"]["streams"][u] == s
               for u, s in passes["spec_k=0"]["streams"].items())
    log(f"  spec_k=4 greedy streams equal to spec_k=0: {same}/8 (bf16 verify rows may "
        f"flip near-ties; not a gate)")

    log("phase 4: the spec_k=0 pass with no kernel on the path "
        "(paged_impl='gather', fused_ln_matmul=False) as the reference")
    paged_flash_attention.launches = ln_matmul.launches = 0
    ref = serve_pass(torch, np, cfg, params, prompts, "gather", record=True,
                     paged_impl="gather")
    if paged_flash_attention.launches or ln_matmul.launches:
        raise SmokeFailure("the reference pass launched a kernel")
    log(f"  gather: {ref['tok_s']:.1f} tok/s, TTFT p50 {ref['ttft_p50_ms']:.2f} ms, "
        f"TPOT p50 {ref['tpot_p50_ms']:.3f} ms")
    for label in ("spec_k=0", "fused_ln_matmul"):
        compare_passes(torch, passes[label], ref, TOL["logits"])
    profile_pass(torch, np, dataclasses.replace(cfg, fused_ln_matmul=True), params, prompts)
    steps = {k: v["steps"] for k, v in passes.items()}
    return launches, counts, steps


def profile_pass(torch, np, cfg, params, prompts):
    """Where the time goes: one more pass (both kernels on the path)
    under torch.profiler — device time by kernel, and the device's busy
    share of the pass's wall time (the rest is the host: Python, eager
    dispatch, host<->device copies of tokens and tables)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        p = serve_pass(torch, np, cfg, params, prompts, "profiled fused_ln_matmul")
    events = [e for e in device_events(torch, prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * p["wall_s"]
    log(f"  profiled pass (fused_ln_matmul, profiler on): wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%), {p['steps']} steps")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs "
              "one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from distributed_tensorflow_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {REPO}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = nvidia_smi_line()
        log(f"card: {smi}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        reports = _build.build_all()
        log(f"phase 1: built {sorted(reports)} in {time.perf_counter() - t0:.1f}s")
        for name, rep in reports.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  [{name}] {line.strip()}")
        kern = phase_kernels(torch, np, F)
        launches, counts, steps = phase_serve(torch, np, smi)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    entries = []
    for name, src, replaces, row in (
        ("paged_attention", "distributed_tensorflow_tpu_torch/ops/csrc/paged_attention.cu",
         "distributed_tensorflow_tpu/ops/flash_attention.py:373",
         kern["paged_attention"]["rows"][0]),
        ("ln_matmul", "distributed_tensorflow_tpu_torch/ops/csrc/ln_matmul.cu",
         "distributed_tensorflow_tpu/ops/fused_ln_matmul.py:53",
         kern["ln_matmul"]["rows"][3]),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": kern[name]["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    log(f"card: {smi}")
    log(f"launches by pass (paged_attention, ln_matmul): {counts}; engine steps by pass: "
        f"{steps}; timed shapes: paged_attention decode B=8 S=1, ln_matmul M=8 n=3072")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

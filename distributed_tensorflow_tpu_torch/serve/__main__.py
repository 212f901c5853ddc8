"""Serving demo on the port — the counterpart of ``examples/serve.py``.

Builds a random-weight causal decoder, submits a few token-id prompts and
streams the completions from the paged continuous-batching engine
(prompts and outputs are vocabulary ids: there is no tokenizer). Runs on
the GPU unless ``--device cpu`` is given; with no CUDA present the GPU
default raises.

Usage:
    python -m distributed_tensorflow_tpu_torch.serve
    python -m distributed_tensorflow_tpu_torch.serve --config tiny --device cpu
    python -m distributed_tensorflow_tpu_torch.serve --prompts 5 --max-new 24 \\
        --temperature 0.8
"""

from __future__ import annotations

import argparse
import random

from ..models import transformer as tfm
from .engine import ServeEngine

CONFIGS = {
    "gpt_small": tfm.gpt_small,
    # the examples/serve.py model
    "tiny": lambda: tfm.TransformerConfig(
        vocab_size=256, max_len=128, num_layers=2, d_model=64, num_heads=4,
        d_ff=128, dtype="float32", causal=True, pre_ln=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompts", type=int, default=3,
                    help="number of random prompts to submit")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2,
                    help="decode-batch slots (fewer than prompts shows "
                         "queueing + slot reuse)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="the slot-dense KV cache (not ported yet: refused)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged cache)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prefill chunk size (paged cache)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="gpt_small")
    args = ap.parse_args(argv)
    if args.dense:
        ap.error("--dense: the slot-dense cache is not ported yet; the port "
                 "serves from the paged pool only")

    cfg = CONFIGS[args.config]()
    eng = ServeEngine.with_random_params(
        cfg, seed=args.seed, device=args.device, num_slots=args.slots,
        temperature=args.temperature, top_k=args.top_k,
        block_size=args.block_size, prefill_chunk=args.prefill_chunk,
    )
    rng = random.Random(args.seed)
    prompts = [
        [rng.randrange(cfg.vocab_size) for _ in range(rng.randint(3, 10))]
        for _ in range(args.prompts)
    ]
    for p in prompts:
        eng.submit(p, max_new_tokens=args.max_new)
    print(f"submitted {len(prompts)} prompts into {args.slots} slots "
          f"({args.config} on {eng.device})\n")
    while eng.sched.has_work:
        stats = eng.step()
        for uid, tok in stats.tokens:
            print(f"  req {uid} += {tok}")
        for uid in stats.finished:
            print(f"  req {uid} done")
    print()
    for req in eng.sched.drain_finished().values():
        print(f"req {req.uid}: prompt={list(req.prompt)}")
        print(f"        -> {req.generated}  ({req.finish_reason})")

    reg = eng.registry
    ms = lambda s: f"{s * 1e3:.1f}ms"  # noqa: E731
    ttft, tpot = reg.get("serve_ttft_seconds"), reg.get("serve_tpot_seconds")
    print(f"\ntelemetry: ttft p50={ms(ttft.percentile(0.5))} "
          f"p99={ms(ttft.percentile(0.99))}  "
          f"tpot p50={ms(tpot.percentile(0.5))}  "
          f"tokens={int(reg.get('serve_tokens_total').value)}")
    print(f"paged kv: block_size={args.block_size} "
          f"pool={eng.cache.num_blocks} blocks  "
          f"reuse_hits={int(reg.get('prefix_reuse_hits_total').value)}  "
          f"prefill_chunks={int(reg.get('prefill_chunks_total').value)}  "
          f"cow_copies={eng.alloc.cow_copies}")
    eng.drain()
    if eng.alloc.blocks_free != eng.cache.num_blocks:
        raise SystemExit("block leak at shutdown")


if __name__ == "__main__":
    main()

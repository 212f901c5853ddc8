#!/usr/bin/env python
"""Convert Criteo-format CTR TSV into the fixed-size CTR record file the
PyTorch port's Wide&Deep workload reads (`--data.dataset=ctr:<path>`,
distributed_tensorflow_tpu_torch/data/recsys.py CTRRecordDataset over the
record loader) — the counterpart of tools/make_ctr_records.py, with the
same bytes out for the same input, importing torch's package only.

Input format (the Criteo display-advertising layout the reference's
Wide&Deep consumed): one example per line,
``label \\t I1..In_dense \\t C1..Cn_cat`` — integer dense features and
hex-string categorical features, empty fields = missing. Field counts
are inferred from the first line (Criteo: 13 dense, 26 categorical).

Transforms (the standard recipe):
- dense: ``log1p(max(v, 0))`` f32, missing -> 0
- categorical: SplitMix64 hash of the raw token, modulo ``--vocab-size``
  (missing -> id 0). Stable across runs/hosts — no Python hash().

Writes ``OUT`` (records) + ``OUT.meta.json`` (field counts, vocab sizes,
row count) and prints the exact training flags.

Usage:
  python tools/make_ctr_records_torch.py OUT train.txt [more.txt...] \\
      [--vocab-size 100003] [--limit N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def hash_token(tok: str, vocab: int) -> int:
    """Stable categorical hash: bytes -> u64 chain -> mod vocab.
    Reserved: missing -> 0, so real tokens land in [1, vocab)."""
    h = 0x243F6A8885A308D3
    for b in tok.encode("utf-8"):
        h = _splitmix64(h ^ b)
    return 1 + h % (vocab - 1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--vocab-size", type=int, default=100003,
                    help="hash-mod vocab per categorical field")
    ap.add_argument("--n-dense", type=int, default=None,
                    help="dense field count (default: min(13, n_fields-1) "
                         "— the Criteo layout); set explicitly for other "
                         "splits")
    ap.add_argument("--limit", type=int, default=None,
                    help="stop after N examples")
    args = ap.parse_args()

    from distributed_tensorflow_tpu_torch.data.recsys import ctr_record_dtype

    n_dense = args.n_dense
    n_cat = None
    dt = None
    total = 0
    # token -> hashed id cache: Criteo categorical tokens repeat heavily,
    # so this collapses the per-byte Python hashing to one pass per
    # UNIQUE token (the difference between hours and minutes at scale)
    tok_cache: dict[str, int] = {}

    def hash_cached(tok: str) -> int:
        h = tok_cache.get(tok)
        if h is None:
            h = tok_cache[tok] = hash_token(tok, args.vocab_size)
        return h

    def flush(chunk: list[list[str]], out) -> None:
        nonlocal total
        if not chunk:
            return
        arr = np.zeros(len(chunk), dt)
        arr["label"] = [float(p[0] or 0) for p in chunk]
        dense = np.zeros((len(chunk), n_dense), np.float64)
        for r, parts in enumerate(chunk):
            for i, v in enumerate(parts[1 : 1 + n_dense]):
                if v:
                    try:
                        dense[r, i] = max(float(v), 0.0)
                    except ValueError:
                        raise SystemExit(
                            f"non-numeric dense field {v!r} at column "
                            f"{1 + i} — is --n-dense={n_dense} right for "
                            "this file?") from None
            arr["cat"][r] = [hash_cached(v) if v else 0
                             for v in parts[1 + n_dense :]]
        arr["dense"] = np.log1p(dense)
        arr.tofile(out)
        total += len(chunk)

    chunk: list[list[str]] = []
    with open(args.out, "wb") as out:
        for path in args.files:
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if n_cat is None:
                        # infer the layout from the first line: Criteo is
                        # 1 label + 13 dense + 26 categorical
                        n_total = len(parts) - 1
                        if n_dense is None:
                            n_dense = min(13, n_total)
                        n_cat = n_total - n_dense
                        if n_cat <= 0:
                            raise SystemExit(
                                f"{path}: need >= 1 categorical field "
                                f"after {n_dense} dense; line has "
                                f"{n_total} features (--n-dense wrong?)")
                        dt = ctr_record_dtype(n_dense, n_cat)
                    if len(parts) != 1 + n_dense + n_cat:
                        continue  # malformed line
                    chunk.append(parts)
                    if len(chunk) >= 65536:
                        flush(chunk, out)
                        chunk = []
                    if args.limit and total + len(chunk) >= args.limit:
                        break
            flush(chunk, out)
            chunk = []
            print(f"{path}: {total} examples so far", file=sys.stderr)
            if args.limit and total >= args.limit:
                break
    if total == 0:
        raise SystemExit("no examples converted")

    meta = {
        "n_records": total,
        "dense_features": n_dense,
        "vocab_sizes": [args.vocab_size] * n_cat,
        "record_bytes": dt.itemsize,
    }
    with open(args.out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {args.out}: {total} records "
          f"({n_dense} dense, {n_cat} categorical, "
          f"{dt.itemsize} B/record)")
    vs = ",".join(str(args.vocab_size) for _ in range(n_cat))
    print(f"train: python -m distributed_tensorflow_tpu_torch.train wide_deep "
          f"--data.dataset=ctr:{args.out} "
          f"--model.dense_features={n_dense} "
          f"--model.vocab_sizes=[{vs}]", file=sys.stderr)


if __name__ == "__main__":
    main()

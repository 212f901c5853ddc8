#!/usr/bin/env python
"""Convert an ImageFolder-layout directory (class_name/xxx.jpg) into the
PyTorch port's JPEG record pair (<out>.dat + <out>.idx, the layout of
distributed_tensorflow_tpu_torch/data/jpeg_records.py) by raw byte
concatenation: the JPEG streams are copied verbatim, never decoded or
re-encoded, so conversion is IO-bound and lossless. Labels are the sorted
class-directory index (the torchvision ImageFolder convention); a
<out>.classes.json sidecar records the mapping. The pair feeds
``--data.dataset=jpeg:<out>`` of the port's resnet50_imagenet.

Usage:
  tools/make_jpeg_records_torch.py /data/imagenet/train /data/records/train \
      [--shuffle-seed 0] [--no-shuffle] [--limit N]
"""

import argparse
import json
import os
import sys
from itertools import zip_longest

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from distributed_tensorflow_tpu_torch.data.jpeg_records import _ENTRY  # noqa: E402

_EXTS = (".jpg", ".jpeg")


def _class_files(class_dir: str) -> tuple[list[str], int]:
    """All JPEGs under a class dir (recursive, case-insensitive extension
    match — the torchvision ImageFolder contract) + skipped-file count."""
    kept, skipped = [], 0
    for root, _, names in sorted(os.walk(class_dir)):
        for f in sorted(names):
            if f.lower().endswith(_EXTS):
                kept.append(os.path.join(root, f))
            else:
                skipped += 1
    return kept, skipped


def convert(src: str, out: str, shuffle_seed: int | None = 0,
            limit: int | None = None) -> int:
    if limit is not None and limit <= 0:
        raise ValueError(f"--limit must be positive, got {limit}")
    classes = sorted(
        d for d in os.listdir(src)
        if os.path.isdir(os.path.join(src, d))
    )
    if not classes:
        raise ValueError(f"no class subdirectories under {src}")
    files, skipped = [], 0
    for label, c in enumerate(classes):
        kept, skip = _class_files(os.path.join(src, c))
        files.extend((p, label) for p in kept)
        skipped += skip
    if skipped:
        print(f"note: skipped {skipped} non-JPEG files", file=sys.stderr)
    if not files:
        raise ValueError(f"no .jpg/.jpeg files under {src}")
    if shuffle_seed is not None:
        # pre-shuffle so sequential readers of the .dat stream well even
        # before the per-epoch index shuffle kicks in
        np.random.RandomState(shuffle_seed).shuffle(files)
    elif limit is not None and limit < len(files):
        # --no-shuffle + --limit on the label-major list would truncate
        # to the first class(es) only; interleave round-robin per class
        # so the subset keeps every class represented
        by_label: dict[int, list] = {}
        for p, label in files:
            by_label.setdefault(label, []).append((p, label))
        files = [
            pair
            for tier in zip_longest(*by_label.values())
            for pair in tier if pair is not None
        ]
    if limit is not None:
        files = files[:limit]
    entries = np.empty(len(files), _ENTRY)
    off = 0
    with open(out + ".dat", "wb") as dat:
        for i, (path, label) in enumerate(files):
            with open(path, "rb") as f:
                raw = f.read()
            dat.write(raw)
            entries[i] = (off, len(raw), label)
            off += len(raw)
    entries.tofile(out + ".idx")
    with open(out + ".classes.json", "w") as f:
        json.dump(classes, f)
    print(f"{len(files)} images, {len(classes)} classes, "
          f"{off / 1e9:.2f} GB -> {out}.dat/.idx", file=sys.stderr)
    return len(files)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--shuffle-seed", type=int, default=0)
    ap.add_argument("--no-shuffle", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args()
    try:
        convert(args.src, args.out,
                shuffle_seed=None if args.no_shuffle else args.shuffle_seed,
                limit=args.limit)
    except ValueError as e:
        raise SystemExit(str(e))


if __name__ == "__main__":
    main()

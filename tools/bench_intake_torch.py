#!/usr/bin/env python
"""The PyTorch port's bench (ResNet-50 fused + pallas backward, batch 256 a
card) with synthetic and with JPEG-fed pipeline windows, in turns
(synthetic, jpeg, jpeg, synthetic), on one card or under torchrun on N.

Each run is ``python -m distributed_tensorflow_tpu_torch.bench`` (or
``torchrun --nproc_per_node=N -m ...``) with ``BENCH_DATA`` set; the JSON
line of each is summarised with the card's name and power limit, and
with ``--out PATH`` the whole lines are written to PATH. With
``BENCH_DATA=jpeg`` the decoder is the native libjpeg stage where it
builds, else PIL (``fed_data`` says which).

Usage::

    python tools/bench_intake_torch.py [--nproc N] [--out PATH] [--device cpu]

(``--device cpu``: the bench's tiny CPU size, a rehearsal.)
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("fed_data", "value", "pipeline_fed_images_per_sec_per_chip", "pipeline_efficiency",
        "host_decode_images_per_sec", "host_cores", "n_chips", "global_batch")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--out", help="write every bench JSON line to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip() if args.device == "cuda" else "cpu")
    print(f"cards: {smi}", flush=True)
    cmd = ([sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={args.nproc}"]
           if args.nproc > 1 else [sys.executable])
    rows = []
    for data in ("synthetic", "jpeg", "jpeg", "synthetic"):
        env = dict(os.environ, BENCH_DATA=data, BENCH_BLOCK_IMPL="fused",
                   DTF_FUSED_BWD="pallas", PYTHONPATH=REPO)
        out = subprocess.run([*cmd, "-m", "distributed_tensorflow_tpu_torch.bench",
                              "--device", args.device], env=env,
                             cwd=REPO, capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise SystemExit(f"bench with BENCH_DATA={data} exited {out.returncode}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(json.dumps({k: row.get(k) for k in KEYS}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in rows)
    print(f"cards: {smi}", flush=True)


if __name__ == "__main__":
    main()

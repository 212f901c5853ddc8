"""Evaluate a workload's checkpoint on the port without training — the
counterpart of ``examples/eval.py`` (the reference evaluated
single-process from ``latest_checkpoint``).

Usage:
    python -m distributed_tensorflow_tpu_torch.evaluate <workload> \\
        --checkpoint.directory=DIR [--device cpu] [--section.key=value ...]
    python -m distributed_tensorflow_tpu_torch.evaluate mnist_mlp \\
        --checkpoint.directory=/tmp/ck --device cpu
    python -m distributed_tensorflow_tpu_torch.evaluate cifar10_cnn \\
        --checkpoint.directory=/tmp/ck --mesh.data=-1 --train.eval_batches=8

The workload is built with the same overrides as the run that wrote DIR
(the model's shape and the data source), the newest step is restored and
``--train.eval_batches`` batches of its eval stream are evaluated; the
metrics and the restored step are printed. Runs on the GPU unless
``--device cpu`` is given (with no CUDA present the GPU default raises);
under ``torchrun`` every process evaluates its rows and process 0 prints.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .parallel import cluster
from .workloads import available, eval_workload

USAGE = ("python -m distributed_tensorflow_tpu_torch.evaluate <workload> "
         "--checkpoint.directory=DIR [--device cpu] [--section.key=value ...]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(usage=f"{USAGE}\nworkloads: {', '.join(available())}",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("workload", choices=available())
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    args, overrides = ap.parse_known_args(argv)
    bad = [o for o in overrides if not (o.startswith("--") and "=" in o)]
    if bad:
        ap.error(f"overrides must be --section.key=value, got {bad}")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        metrics = eval_workload(args.workload, overrides, device=args.device)
        if cluster.is_chief():
            print("eval " + " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    finally:
        cluster.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

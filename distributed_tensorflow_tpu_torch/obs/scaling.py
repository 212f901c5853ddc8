"""The provenance block of a measurement — the ``provenance`` /
``stamp_provenance`` subset of ``distributed_tensorflow_tpu/obs/
scaling.py``: what ran, read from the live runtime at measurement time
(never from flags), so that a CPU row can never read as a card's. The
sweep runner and its validator are not ported (ROADMAP Queue A item 6)."""

from __future__ import annotations

import os
import socket
import subprocess


def git_sha(repo_dir: str | None = None) -> str:
    """HEAD of the checkout holding this package, or "unknown"."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "-C", repo_dir, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"


def power_limit(index: int = 0) -> str:
    """Card ``index``'s power limit as ``nvidia-smi --query-gpu=power.limit``
    reports it (e.g. "700.00 W"); raises when nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def provenance(mesh=None, device=None) -> dict:
    """Backend, platform, device name, power limit, device count, mesh,
    hostname, git sha and pid of this process's run. ``mesh`` (a
    ``parallel.mesh.Mesh``) gives the device and the axis sizes; else
    ``device`` (the card by default)."""
    import torch

    from ..parallel.cluster import process_count

    dev = mesh.device if mesh is not None else torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    import torch.distributed as dist

    prov = {
        "backend": (dist.get_backend() if dist.is_available() and dist.is_initialized()
                    else "none"),
        "platform": "gpu" if cuda else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "power_limit": power_limit(dev.index) if cuda else None,
        "device_count": mesh.size if mesh is not None else process_count(),
        "hostname": socket.gethostname(),
        "git_sha": git_sha(),
        "pid": os.getpid(),
    }
    if mesh is not None:
        prov["mesh"] = dict(mesh.shape)
    return prov


def stamp_provenance(payload: dict, mesh=None, device=None) -> dict:
    """Add the provenance block to ``payload`` in place and return it."""
    payload["provenance"] = provenance(mesh, device)
    return payload

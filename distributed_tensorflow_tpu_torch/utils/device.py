"""Where the port's tensors go: ``resolve_device`` turns a device name into
a ``torch.device`` and refuses a CUDA device when no card is present —
every entry point and helper runs on the card unless its caller asks for
the CPU, and none falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no CUDA present
    raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU")
    return dev

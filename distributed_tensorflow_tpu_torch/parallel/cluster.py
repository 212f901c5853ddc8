"""Multi-process bootstrap — the port's counterpart of
``distributed_tensorflow_tpu/parallel/cluster.py``.

Every process runs the same program, one per card. ``initialize`` starts
the default ``torch.distributed`` process group: NCCL on the card, gloo
on the CPU. It takes the peers either from ``ClusterConfig``
(``coordinator_address``, ``num_processes``, ``process_id`` map to a
``tcp://`` init method) or from the variables ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). A single process with none of these starts no group,
as the JAX package does. Process 0 is the chief: it does the singleton
host work (logging), nothing more. The JAX package's compilation cache
and TPU-pod autodetection have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Topology flags; all default to a single process (or to what
    ``torchrun`` set)."""

    coordinator_address: str | None = None  # "host:port" of process 0
    num_processes: int | None = None
    process_id: int | None = None
    # this process's card: local_device_ids[0]; default LOCAL_RANK (0)
    local_device_ids: tuple[int, ...] | None = None


def _env_configured() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(config: ClusterConfig | None = None, device="cuda") -> torch.device:
    """Start the default process group if ``config`` or ``torchrun``'s
    variables name peers (idempotent: a group already up is kept), and
    return this process's device: on the card (the default; raises
    without one unless ``device="cpu"``), ``cuda:<local id>``, made the
    current device before the group starts, as NCCL needs."""
    import torch.distributed as dist

    config = config or ClusterConfig()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if config.local_device_ids:
            local = config.local_device_ids[0]
        else:
            local = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    explicit = config.coordinator_address is not None
    if not (explicit or _env_configured()):
        return dev  # one process: no group
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if explicit:
        if config.num_processes is None or config.process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kw = dict(init_method=f"tcp://{config.coordinator_address}",
                  world_size=config.num_processes, rank=config.process_id)
    dist.init_process_group(backend, **kw)
    logger.info("torch.distributed initialized: process %d/%d, %s on %s",
                dist.get_rank(), dist.get_world_size(), backend, dev)
    return dev


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_chief() -> bool:
    """Process 0: the singleton host work (logging). It holds no special
    state."""
    return process_index() == 0


def sync_hosts(name: str = "sync") -> None:
    """Barrier across processes; no-op in a single process."""
    import torch.distributed as dist

    if process_count() > 1:
        logger.debug("sync_hosts(%s)", name)
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()

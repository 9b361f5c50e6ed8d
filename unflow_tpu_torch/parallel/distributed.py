"""Several processes, one GPU each: the process group and each process's
share of the batch.

Port of ``unflow_tpu/parallel/distributed.py`` on ``torch.distributed``. The
JAX package runs one program over every device of a host and one process
per host; PyTorch's idiom, followed here, is one process per GPU, started by
``torchrun``, which names the group in the environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    torchrun --nproc-per-node 2 -m unflow_tpu_torch.cli.train --config ... --ex ...

Every process trains on its contiguous slice of each global batch (the
``Loader``'s ``shard`` is ``spatial.data_shard()``, which is
``process_shard`` without W-sharding), and only the lead process writes
files. Without that environment every function here describes the
one process there is.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from unflow_tpu_torch.parallel import spatial

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: torch.device | str = "cuda", backend: str | None = None) -> bool:
    """Join the process group the environment names (``torchrun``'s
    variables); a no-op returning False when it names none, as in a plain
    ``python -m ...`` run. The backend follows ``device``: NCCL for CUDA,
    gloo for the CPU. ``backend`` overrides it (gloo also takes CUDA
    tensors, which lets two processes share one card). Idempotent: True once
    the process is in a group."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend)
    return True


def local_device(device: torch.device | str) -> torch.device:
    """This process's device: ``cuda`` means ``cuda:LOCAL_RANK``; a device
    with an index, or the CPU, is taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def process_shard() -> tuple[int, int]:
    """(rank, world size): the ``Loader``'s ``shard`` argument."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_lead_process() -> bool:
    """True on the process that writes the experiment's files (metrics,
    tensorboard, checkpoints, the config snapshot)."""
    return process_shard()[0] == 0


def per_process_batch_size(global_batch: int) -> int:
    """This process's rows of a global batch of ``global_batch`` pairs: the
    batch splits over the data ranks, the processes over ``spatial_shards``
    (``parallel/spatial.py``; the ranks of a spatial group share rows)."""
    world, s = process_shard()[1], spatial.spatial_size()
    n = world // s
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes"
                         + (f" (data ranks: {world} processes / spatial_shards {s})"
                            if s > 1 else ""))
    return global_batch // n


def barrier() -> None:
    """Wait for every process of the group (nothing to wait for without one)."""
    if dist.is_initialized():
        dist.barrier()


__all__ = [
    "barrier",
    "init_distributed",
    "is_lead_process",
    "local_device",
    "per_process_batch_size",
    "process_shard",
]

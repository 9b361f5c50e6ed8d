"""Parallelism over several GPUs: batch split (and W split), parameters
replicated, gradients averaged.

Port of ``unflow_tpu/parallel``. The JAX package shards the batch axis over
a device mesh (and W over its second, ``spatial`` axis), replicates the
parameters and lets XLA insert the gradient all-reduce and the halo
exchanges. Here each process owns one GPU and its rows of every global
batch (``parallel/distributed.py``), and ``DistributedDataParallel``
averages the gradients over every process in buckets during the backward
pass. With ``spatial_shards = S`` the processes form a (data, spatial) grid
and each one of a spatial group holds a W-slab of its rows
(``parallel/spatial.py``); there is no mesh object.
"""

from __future__ import annotations

import torch

from unflow_tpu_torch.parallel.distributed import (
    barrier,
    init_distributed,
    is_lead_process,
    local_device,
    per_process_batch_size,
    process_shard,
)
from unflow_tpu_torch.parallel.spatial import (
    SpatialContext,
    check_grid,
    data_shard,
    init_grid,
    reset_grid,
    spatial_shard,
)


def local_batch_size(global_batch: int) -> int:
    """The pairs of a global batch that one process (one GPU) trains on (the
    ranks of a spatial group, each on its W-slab of the same pairs)."""
    return per_process_batch_size(global_batch)


def check_num_devices(num_devices: int) -> None:
    """``num_devices`` of a config is 0 (the processes ``torchrun`` started)
    or their number; anything else raises, naming both, and a run of one
    process asked for several GPUs names the command that starts them."""
    world = process_shard()[1]
    if num_devices in (0, world):
        return
    if world == 1:
        raise ValueError(
            f"num_devices = {num_devices}, but this is one process: start one process per "
            f"GPU with `torchrun --nproc-per-node {num_devices} -m unflow_tpu_torch.cli.train "
            "--config ... --ex ...`"
        )
    raise ValueError(f"num_devices = {num_devices}, but torchrun started {world} processes")


def wrap_model(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``model`` as it is in one process; with several,
    ``DistributedDataParallel`` over its trainable parameters (frozen stages
    take no part), which averages their gradients across all the processes
    (the ranks of a spatial group too: the parameters are replicated on
    every rank). Its construction broadcasts the lead's parameters to every
    process."""
    if process_shard()[1] == 1:
        return model
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None
    )


__all__ = [
    "SpatialContext",
    "barrier",
    "check_grid",
    "check_num_devices",
    "data_shard",
    "init_distributed",
    "init_grid",
    "is_lead_process",
    "local_batch_size",
    "local_device",
    "per_process_batch_size",
    "process_shard",
    "reset_grid",
    "spatial_shard",
    "wrap_model",
]

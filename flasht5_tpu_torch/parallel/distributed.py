"""Process-group setup and per-process data slices.

The counterpart of `flasht5_tpu/parallel/distributed.py`. The JAX package
joins the hosts of a slice with `jax.distributed.initialize`, after which
every host sees every device; here each process drives one card (one rank
per card) and joins the others through `torch.distributed`: NCCL between
cards, gloo between CPU processes (the tests' four ranks).

`make_multihost_array` has no counterpart: a rank's tensors are already
local, and a rank takes its own slice of a global batch
(`host_local_batch_slice`, or `sharding.batch_slice` for a rank's slice
over a mesh's "data" dimension).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device: Optional[str] = None) -> dict:
    """Join (or find) the default process group and return the JAX
    function's summary {process_index, process_count, local_devices,
    global_devices}.

    The arguments default to the `torchrun` environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT); `coordinator_address`
    ("host:port", or an init URL such as "file:///path") names the
    rendezvous explicitly. `device` "cuda" (the
    default) joins over NCCL, one card a rank, after
    `torch.cuda.set_device(LOCAL_RANK)`; "cpu" over gloo. A failure to join
    is raised, never passed over."""
    device = device or "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for gloo ranks on the CPU")
        local_rank = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local_rank)
    if not dist.is_initialized():
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        init = "env://"
        if coordinator_address:
            init = (coordinator_address if "://" in coordinator_address
                    else f"tcp://{coordinator_address}")
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=init, rank=rank,
                                world_size=world)
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_devices": 1, "global_devices": world}


def host_local_batch_slice(global_batch_size: int) -> slice:
    """The rows of a globally indexed batch this process loads: an equal
    share by rank (JAX distributed.py:49-57, one process per card)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    count = dist.get_world_size() if dist.is_initialized() else 1
    per = global_batch_size // count
    return slice(rank * per, (rank + 1) * per)

"""Multi-process initialization and per-process data feeding
(whisper_tpu/parallel/multihost.py).

The JAX package runs one process per host, which sees every chip of its
host; `jax.distributed.initialize` joins the hosts. torch.distributed
runs one process per rank, so `initialize` wraps `init_process_group`
and reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) where JAX reads the TPU pod's. What a multi-process run
needs from the package:

  1. `initialize()`: once per process, before make_mesh. Where CUDA is,
     it first pins the process to its own card (`pin_device`: torchrun's
     LOCAL_RANK, else the rank modulo the host's cards), since "cuda"
     means the current card and NCCL refuses two ranks on one. A single
     process with no arguments and no torchrun environment is the
     degenerate case: nothing happens, and make_mesh opens a world of one
     itself.
  2. `global_batch()`: each process's rows of the request batch (its dp
     shard) assembled into the global batch that ShardedPipeline takes.
  3. `is_coordinator()`: gates logging and serving frontends to rank 0.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from whisper_tpu_torch.ops import collectives


def _torchrun_env() -> bool:
    """True when a launcher set a world of more than one process."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join this process to the world (:38-61). coordinator_address is
    rank 0's "host:port" (else torchrun's MASTER_ADDR/MASTER_PORT),
    num_processes and process_id the world size and this rank (else
    WORLD_SIZE and RANK). The backend is NCCL where CUDA is, after
    pin_device, else gloo; collectives time out after
    ops/collectives.TIMEOUT. A no-op when the process group exists
    already, and for a single process with no arguments outside a
    launcher."""
    if dist.is_initialized():
        return                      # idempotent: a second call is a no-op
    if (coordinator_address is None and num_processes in (None, 1)
            and process_id is None and not _torchrun_env()):
        return                      # single-process run: nothing to do
    rank = (int(os.environ.get("RANK", "0")) if process_id is None
            else process_id)
    cuda = torch.cuda.is_available()
    if cuda:
        pin_device(rank)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=init,
        world_size=num_processes or -1,
        rank=-1 if process_id is None else process_id,
        timeout=collectives.TIMEOUT)


def local_device(rank: int) -> int:
    """The card of the process of global `rank`: torchrun's LOCAL_RANK
    where it is set, else the rank modulo the host's cards (one process a
    card, hosts filled in rank order)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def pin_device(rank: int) -> int:
    """Make local_device(rank) this process's current card, so that
    "cuda" (its collectives, its shard, its kernels) means that card.
    Returns its index."""
    index = local_device(rank)
    torch.cuda.set_device(index)
    return index


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def global_batch(local_rows, mesh=None, axis: str = "dp") -> torch.Tensor:
    """Each process's rows (global_batch_size / dp of them, the same rows
    on every rank of one dp shard) assembled along the batch axis in dp
    order, on every rank: the batch ShardedPipeline.transcribe_batch
    takes. A single process, or a mesh whose `axis` has one rank, gets its
    rows back as a tensor."""
    x = torch.as_tensor(np.asarray(local_rows))
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return x
    return collectives.all_gather(x, mesh.get_group(axis), dim=0)


def global_batch_size(local_batch: int) -> int:
    """local_batch x the process count, as in JAX: one dp shard a
    process."""
    return local_batch * (dist.get_world_size() if dist.is_initialized()
                          else 1)

"""Process-group bring-up and sweep sharding (port of
``nerfca_tpu/parallel/multihost.py``).

:func:`initialize` wraps ``torch.distributed.init_process_group``, from
explicit arguments or from the ``env://`` settings (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), so that every rank's devices
join one mesh (``mesh.make_mesh``); :func:`shard_sweep` statically splits a
sweep grid across processes, each training its share alone.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: str = "nccl",
               strict: Optional[bool] = None) -> dict:
    """Bring up the process group: ``coordinator_address`` (``host:port`` of
    rank 0), ``num_processes`` and ``process_id`` given explicitly, or none
    of them and the ``env://`` settings. ``backend`` is ``"nccl"`` (one card
    a rank) or ``"gloo"`` (CPU tensors, or ranks sharing a card).

    ``strict`` defaults to True whenever an explicit argument is given: a
    misconfigured group raises instead of degrading to one process. With
    no arguments it defaults to False: a plain single-process run warns and
    carries on. A group that is already up is kept. Returns a summary."""
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if strict is None:
        strict = explicit
    if not dist.is_initialized():
        try:
            if explicit:
                if None in (coordinator_address, num_processes, process_id):
                    raise ValueError("initialize needs coordinator_address, num_processes and "
                                     "process_id together")
                dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                        world_size=num_processes, rank=process_id)
            else:
                dist.init_process_group(backend, init_method="env://")
        except (ValueError, RuntimeError) as e:
            if strict:
                raise
            warnings.warn(f"torch.distributed.init_process_group failed ({e}); continuing "
                          f"single-process")
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    local = torch.cuda.device_count() if (up and dist.get_backend() == "nccl") else 1
    return {"process_index": dist.get_rank() if up else 0, "process_count": world,
            "local_devices": local, "global_devices": world}


def shard_sweep(grid: Sequence, process_id: Optional[int] = None,
                process_count: Optional[int] = None) -> list:
    """This process's share of a sweep grid, round-robin by rank (the whole
    grid in a single-process run)."""
    up = dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    n = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return [item for i, item in enumerate(grid) if i % n == pid]

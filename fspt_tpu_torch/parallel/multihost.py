"""Multi-process bring-up over torch.distributed: port of
fspt_tpu.parallel.multihost.

Usage in every process of a job (one process a card, or CPU processes):

    from fspt_tpu_torch.parallel import dist, multihost
    multihost.initialize()                  # the process group's handshake
    mesh = multihost.global_mesh()          # 1-D "rays" mesh over all ranks
    step = dist.make_sharded_sample_step(mesh, cfg, scene.meta)

Rendering then shards the framebuffer's lanes over every rank of the job;
the scene is replicated; the train step's gradients are all-reduced over
the group (NCCL between cards, gloo between CPU processes).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fspt_tpu_torch.parallel.dist import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group with env-var defaults
    (COORDINATOR_ADDRESS as host:port, NUM_PROCESSES, PROCESS_ID); a no-op
    when the job is one process.  backend: "nccl" when a card is present
    (the process then takes card process_id % the cards it sees as its
    current device), "gloo" otherwise; an explicit backend wins (two ranks
    on one card need "gloo": NCCL refuses a card twice)."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("NUM_PROCESSES", "1"))
    if num <= 1:
        return
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        raise ValueError("multihost.initialize: no coordinator address "
                         "(pass one or set COORDINATOR_ADDRESS=host:port)")
    pid = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=num, rank=pid)


def global_mesh(axis_name: str = "rays", device=None) -> Mesh:
    """1-D mesh over every rank of the job, one shard a rank on its device
    (dist.make_mesh; device "cuda" by default)."""
    return make_mesh(None, axis_name, device)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0

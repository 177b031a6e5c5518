"""Joining a multi-process run.

Counterpart of ``laplace_gnn_tpu/parallel/distributed.py::initialize``,
on ``torch.distributed``: NCCL between cards, Gloo between CPU processes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from ..device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group (idempotent); True when the run has more
    than one process after the call.

    The arguments default to the environment variables
    ``LAPLACE_GNN_COORDINATOR`` (``host:port`` of process 0, or a
    ``tcp://`` / ``file://`` rendezvous URL),
    ``LAPLACE_GNN_NUM_PROCESSES`` and ``LAPLACE_GNN_PROCESS_ID``. With
    neither an address nor a process count it does nothing and returns
    False. The group uses NCCL on ``cuda`` (the default) and Gloo when the
    caller passes ``device="cpu"``."""
    coordinator_address = coordinator_address or os.environ.get(
        "LAPLACE_GNN_COORDINATOR")
    if num_processes is None and "LAPLACE_GNN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LAPLACE_GNN_NUM_PROCESSES"])
    if process_id is None and "LAPLACE_GNN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LAPLACE_GNN_PROCESS_ID"])
    if not dist.is_initialized():
        if coordinator_address is None and num_processes is None:
            return False
        backend = "nccl" if resolve_device(device).type == "cuda" \
            else "gloo"
        if coordinator_address is None:
            init_method = "env://"
        elif "://" in coordinator_address:      # tcp://... or file://...
            init_method = coordinator_address
        else:
            init_method = f"tcp://{coordinator_address}"
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1

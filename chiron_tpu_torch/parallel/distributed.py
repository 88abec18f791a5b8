"""Multi-process cluster initialization (port of
``chiron_tpu/parallel/distributed.py``).

Where the JAX package starts ``jax.distributed``, the port starts a
``torch.distributed`` process group: NCCL between CUDA devices, gloo on the
CPU.  One process drives one device.

Usage under ``torchrun --nproc_per_node=4 script.py``::

    from chiron_tpu_torch.parallel import distributed, make_replica_mesh
    distributed.initialize_cluster()     # reads RANK, WORLD_SIZE, LOCAL_RANK
    mesh = make_replica_mesh(axis_name="spatial")   # spans every process

A single process (no torchrun environment, nothing passed) may call it as a
no-op.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("chiron_tpu_torch")


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    store=None,
) -> bool:
    """Initialize the default ``torch.distributed`` process group.

    The rank and world size come from the arguments or from torchrun's
    ``RANK`` and ``WORLD_SIZE``; the rendezvous from ``store`` (for example
    a ``torch.distributed.FileStore``, which needs no network port), from
    ``coordinator_address`` ("host:port") or from ``MASTER_ADDR`` and
    ``MASTER_PORT``.  On a CUDA ``device`` the group is NCCL and this
    process's device becomes ``LOCAL_RANK`` (else its rank); on the CPU it
    is gloo.  Returns True when the group is up (also when it already was),
    False when running single-process, where it does nothing.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None and coordinator_address is None and store is None:
        log.info("single-process run; torch.distributed not initialized")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_cluster: pass num_processes and process_id, or run "
            "under torchrun (RANK, WORLD_SIZE)"
        )
    device = torch.device(device)
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    else:
        backend = "gloo"
    kwargs = dict(backend=backend, rank=process_id, world_size=num_processes)
    if store is not None:
        kwargs["store"] = store
    elif coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    dist.init_process_group(**kwargs)
    log.info("distributed: process %d/%d on %s (%s)", process_id,
             num_processes, device, backend)
    return True

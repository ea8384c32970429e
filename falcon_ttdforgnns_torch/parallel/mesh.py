"""The process group of the port's multi-device paths (port of
``falcon_ttdforgnns_tpu/parallel/mesh.py``).

JAX builds a device mesh over the chips one program sees and lets XLA
insert the collectives.  torch runs one process per card, so the port's
"mesh" is a ``torch.distributed`` process group of W ranks, one card each
(``cuda:LOCAL_RANK``).  This module has the data axis only; the node axis
of ``--node-shard`` is ROADMAP A8.3.

The backend follows the device the caller asked for, never what the host
has: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``.  A CUDA device without
NCCL raises; nothing falls back to gloo, whose collectives would move CUDA
tensors through the host.

:func:`init_multihost` is ``--multihost``: it reads ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or JAX's (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``), joins the group, and returns its world size; in a single
process, with neither set, it does nothing and returns 1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The backend of ``device``'s type: ``nccl`` for cuda, ``gloo`` for cpu."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    return BACKENDS[kind]


def world_size(group=None) -> int:
    """The ranks of ``group`` (the default group without one), 1 where no
    group was set up."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``, 0 where no group was set up."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def init_process_group(device, init_method: str = "env://", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None) -> int:
    """Join the default process group of ``device``'s backend and, for
    ``cuda``, take the card ``cuda:local_rank`` (``LOCAL_RANK``, default 0)
    as this process's current device.  ``init_method`` is where the ranks
    meet (``env://``, ``tcp://host:port`` or ``file://path``).  Returns the
    world size."""
    backend = backend_for(device)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA process group needs NCCL, which this torch lacks")
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for, but "
                               "torch.cuda.is_available() is False")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local_rank)
    given = {k: v for k, v in (("rank", rank), ("world_size", world_size)) if v is not None}
    dist.init_process_group(backend, init_method=init_method, **given)
    return dist.get_world_size()


def init_multihost(device="cuda") -> int:
    """``--multihost`` (JAX ``init_multihost``): join the process group that
    the environment describes and return its world size.  JAX's variables
    come first: ``COORDINATOR_ADDRESS`` (host:port of rank 0) with
    ``NUM_PROCESSES`` and ``PROCESS_ID``; ``torchrun``'s otherwise.  A
    group already set up is kept.  In a single process, with neither
    environment, nothing is set up and the world size is 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    local = os.environ.get("LOCAL_RANK")
    if coordinator:
        np_ = os.environ.get("NUM_PROCESSES")
        pid = os.environ.get("PROCESS_ID")
        if np_ is None or pid is None:
            # defaulting these would make every host "succeed" as an
            # independent 1-process job — fail fast instead
            raise ValueError(
                "COORDINATOR_ADDRESS is set but NUM_PROCESSES/PROCESS_ID "
                "are not: a manual cluster must specify both (on Cloud TPU "
                "pods leave all three unset for auto-discovery)")
        n, r = int(np_), int(pid)
        cards = torch.cuda.device_count() if backend_for(device) == "nccl" else 1
        init_process_group(device, f"tcp://{coordinator}", r, n,
                           int(local) if local is not None else r % max(cards, 1))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_process_group(device, "env://")
    else:
        return 1
    return dist.get_world_size()


def destroy_process_group() -> None:
    """Leave the default group, where one was set up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()

"""The process group of the port's multi-device paths (port of
``falcon_ttdforgnns_tpu/parallel/mesh.py``).

JAX builds a device mesh over the chips one program sees and lets XLA
insert the collectives.  torch runs one process per card, so the port's
"mesh" is a ``torch.distributed`` process group of W ranks, one card each
(``cuda:LOCAL_RANK``).  :func:`make_mesh` splits a group of W ranks into
JAX's ``(data, node)`` mesh for ``--node-shard`` (:class:`NodeMesh`); the
data axis of ``--dist`` alone is the whole group
(``parallel/data_parallel.py``).

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
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The backend of ``device``'s type: ``nccl`` for cuda, ``gloo`` for cpu."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    return BACKENDS[kind]


def check_backend(group, device, what: str) -> None:
    """Raise unless ``group``'s backend is ``device``'s: a CUDA trainer
    given a gloo group (or a CPU one an NCCL group) raises, nothing falls
    back."""
    backend = dist.get_backend(group)
    if backend != backend_for(device):
        raise ValueError(f"{what} on {torch.device(device).type} needs a "
                         f"{backend_for(device)} process group, got {backend}")


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


def checked_world(num_chips: int, group=None) -> int:
    """The world size of ``group``, which ``--num-chips`` (when set) must
    be: JAX takes the first n of the devices it sees, a torch group has
    one rank a card."""
    n = world_size(group)
    if num_chips > 0 and num_chips != n:
        raise ValueError(f"--num-chips {num_chips} must be the process group's world "
                         f"size ({n}): launch with --nproc-per-node {num_chips}")
    return n


def host_count() -> int:
    """The hosts of a torchrun launch, JAX's ``process_count()`` for the
    hybrid split: ``WORLD_SIZE // LOCAL_WORLD_SIZE``, 1 where unset."""
    world, local = os.environ.get("WORLD_SIZE"), os.environ.get("LOCAL_WORLD_SIZE")
    if world is None or local is None:
        return 1
    return max(1, int(world) // max(1, int(local)))


def resolve_data_shards(n_devices: int, data_shards: int, batch_size: int) -> int:
    """The data axis of ``--dist --node-shard`` over ``n_devices`` ranks
    (JAX ``SageTrainer._resolve_data_shards``, ``trainer.py:408-426``): an
    explicit ``--data-shards`` wins; else one data group per host (the
    data-across-hosts x node-within-a-host layout); on one host 2 where the
    ranks allow, so that ``--dist --node-shard`` means something."""
    if data_shards > 0:
        if n_devices % data_shards:
            raise ValueError(f"--data-shards {data_shards} does not "
                             f"divide {n_devices} devices")
        n_data = data_shards
    elif host_count() > 1 and n_devices % host_count() == 0:
        n_data = host_count()
    else:
        n_data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if batch_size % n_data:
        raise ValueError(f"batch size {batch_size} must divide by "
                         f"the data axis ({n_data})")
    return n_data


@dataclass
class NodeMesh:
    """This rank's place in JAX's ``(data, node)`` mesh of a group of
    ``n_data * n_node`` ranks: group rank r is data index ``r // n_node``
    and node index ``r % n_node``.  ``node_group`` holds the ranks of its
    data index (the ring), ``data_group`` those of its node index;
    ``left`` and ``right`` are the global ranks of node indices ``(j - 1) %
    n_node`` and ``(j + 1) % n_node`` in its ring; ``group`` is the whole
    group (None: the default group)."""

    group: Any
    n_data: int
    n_node: int
    data_index: int
    node_index: int
    node_group: Any
    data_group: Any
    left: int
    right: int

    def rotate(self, t: torch.Tensor, back: bool = False) -> torch.Tensor:
        """One ring rotation: ``t`` goes to the left neighbour and what the
        right one sent comes back (``back``: the other way), one
        ``batch_isend_irecv``."""
        to, frm = (self.right, self.left) if back else (self.left, self.right)
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, to, self.node_group),
               dist.P2POp(dist.irecv, out, frm, self.node_group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


def make_mesh(n_data: int, n_node: int, group=None) -> NodeMesh:
    """Split ``group`` (the default group without one) of ``n_data *
    n_node`` ranks into the data and node axes (JAX ``make_mesh(n_data,
    n_node)``).  Every rank of the default group must call it, in the same
    order as the others: ``dist.new_group`` makes one node subgroup per
    data index, then one data subgroup per node index."""
    n = world_size(group)
    if n_data * n_node != n:
        raise ValueError(f"a {n_data} x {n_node} mesh over {n} ranks")
    world = dist.group.WORLD if group is None else group
    ranks: List[int] = [dist.get_global_rank(world, i) for i in range(n)]
    node_groups = [dist.new_group([ranks[d * n_node + j] for j in range(n_node)])
                   for d in range(n_data)]
    data_groups = [dist.new_group([ranks[d * n_node + j] for d in range(n_data)])
                   for j in range(n_node)]
    r = rank(group)
    d, j = divmod(r, n_node)
    return NodeMesh(group, n_data, n_node, d, j, node_groups[d], data_groups[j],
                    left=ranks[d * n_node + (j - 1) % n_node],
                    right=ranks[d * n_node + (j + 1) % n_node])

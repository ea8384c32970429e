"""``--dist`` data parallelism (port of
``falcon_ttdforgnns_tpu/parallel/data_parallel.py``).

JAX shards the batch over the mesh's ``data`` axis, keeps the parameters
replicated and lets XLA psum the gradients through the loss mean, so that
the data-parallel step is the single-device step on the whole batch
(``trainer.py:815-818``).  The port keeps that identity with W ranks:

* every rank holds the whole batch (the same host loader, or the same
  in-step sampler stream, on every rank) and takes rows
  ``[r B/W, (r+1) B/W)`` of the seeds, the labels and every layer
  (:meth:`DataParallel.shard`);
* the backward runs on the local mean loss times 1/W
  (:meth:`DataParallel.share`), so that every gradient, the TT cores'
  batch totals from ``tt_grads`` among them, is this rank's share of the
  global mean's gradient;
* one coalesced all-reduce a step sums the shares, with the loss and
  accuracy shares in the same buffer (:meth:`DataParallel.all_reduce`), so
  that every rank applies the same update, feeds the same global loss to
  the plateau and reports the global loss and accuracy.

The factor 1/W is applied once, to the loss, and nowhere else.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import check_backend, checked_world, rank, world_size


def scaling_efficiency(edges_per_s: Dict[int, float]) -> Dict[int, float]:
    """edges/s at N chips vs perfect linear scaling from 1 chip
    (BASELINE.json north-star: >=80%)."""
    base = edges_per_s.get(1)
    if not base:
        return {}
    return {n: v / (base * n) for n, v in edges_per_s.items()}


class DataParallel:
    """The data axis of ``--dist``: the W ranks of ``group`` (the default
    group without one), on ``device``, whose type must be the backend's
    (NCCL on the card, gloo on the CPU).  ``reduced_bytes`` is the size of
    the last all-reduce."""

    def __init__(self, device, group=None):
        self.group = group
        self.device = torch.device(device)
        self.world, self.rank = world_size(group), rank(group)
        check_backend(group, self.device, "--dist")
        self.reduced_bytes = 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n``."""
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, seeds, layers: Sequence, labels):
        """This rank's rows of the seeds, every layer and the labels."""
        s = self.rows(len(seeds))
        return seeds[s], [l[s] for l in layers], labels[s]

    def other_rows(self, seeds: torch.Tensor, layers: Sequence[torch.Tensor]):
        """The seeds and layers of the other ranks' rows."""
        s = self.rows(len(seeds))

        def rest(x):
            return torch.cat([x[:s.start], x[s.stop:]])

        return rest(seeds), [rest(l) for l in layers]

    def share(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global mean loss: its local mean over W."""
        return loss / self.world

    def all_reduce(self, loss: torch.Tensor, acc: torch.Tensor,
                   grads: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """Sum every rank's gradient shares (the gradients of :meth:`share`'s
        loss) and its local mean loss and accuracy over W, in one all-reduce
        of one f32 buffer.  Returns the global loss, the global accuracy and
        the summed gradients, views of that buffer."""
        loss, acc, out = reduce_sums(loss.detach().float() / self.world,
                                     acc.float() / self.world, grads, self.group)
        self.reduced_bytes = 4 * (sum(g.numel() for g in grads) + 2)
        return loss, acc, out

    def from_rank0(self, fn: Callable[[], Dict[str, float]], keys: Sequence[str]
                   ) -> Dict[str, float]:
        """``fn()``'s values of ``keys``, computed on rank 0 and broadcast, so
        that every rank has the same; every rank must call this."""
        vals = torch.zeros(len(keys), dtype=torch.float64, device=self.device)
        if self.rank == 0:
            res = fn()
            vals = torch.tensor([res[k] for k in keys], dtype=torch.float64,
                                device=self.device)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(vals, src=src, group=self.group)
        return dict(zip(keys, vals.tolist()))


def reduce_sums(loss: torch.Tensor, acc: torch.Tensor, grads: Sequence[torch.Tensor],
                group=None) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Sum every rank's ``grads``, ``loss`` and ``acc`` over ``group`` in
    one all-reduce of one f32 buffer; returns the sums, views of it."""
    stats = torch.stack([loss.detach().float(), acc.float()])
    flat = torch.cat([*(g.reshape(-1).float() for g in grads), stats])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return flat[off], flat[off + 1], out


def data_parallel_for(cfg, device, group=None) -> Optional[DataParallel]:
    """The data axis of a trainer of ``cfg`` on ``device``, or None for the
    single-device step.  As JAX takes its DP path only when
    ``device_count() > 1`` (``trainer.py:329``), ``--dist`` on a default
    group of one rank (or none) is the single-device path; a ``group``
    given explicitly is taken at any size (one NCCL rank measures the
    step's all-reduce on one card).  ``--num-chips`` must be the world
    size, and the batch must divide by it (``trainer.py:335-337``).
    ``--dist --full-neighbor --node-shard`` is the hybrid split of the
    node mesh (``node_sharding.py``), not this path."""
    if not (cfg.dist and cfg.use_sample):
        if group is not None and not cfg.node_shard:
            raise ValueError("a process group is for --dist or --node-shard")
        return None
    n = checked_world(cfg.num_chips, group)
    if group is None and n == 1:
        return None
    if cfg.batch_size % n:
        raise ValueError(f"batch size {cfg.batch_size} must divide by "
                         f"the data axis ({n})")
    return DataParallel(device, group)

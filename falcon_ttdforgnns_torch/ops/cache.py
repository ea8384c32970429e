"""Software-managed hot-row embedding cache (LFU), on tensors.

Port of ``falcon_ttdforgnns_tpu/ops/cache.py`` (FALCON's third
contribution, `FBTT/tt_embeddings_cuda.cu:1083-1507`): count the accesses
of every node id, keep the top-K rows materialised, and serve those rows
without the TT chain.  As in the JAX package these are plain tensor
operations, not kernels:

- counting: ``index_add_`` of ones over the batch's ids;
- populate: a stable descending sort of the counts, whose first K are the
  top K with the lower id first among equal counts (``jax.lax.top_k``'s
  order; ``torch.topk`` promises none, and its CPU and CUDA orders
  differ), then the K rows through ``tt_fwd`` in chunks (the ported B1
  kernel on the card, its plain version on the CPU);
- lookup: ``searchsorted`` in the sorted id table, whose empty slots hold
  -1 and so sort first;
- the split: hits are looked up as id 0 by the TT path and replaced by
  the cached rows in a select, so their TT rows get a zero gradient and
  the cache rows the hits' gradient (``index_select``'s backward, an
  ``index_add_`` into a dense (K, D) gradient).

The metadata (``CacheMeta``: counts, sorted ids, ready flag) belongs to
the module that owns the cache (``nn/tt_embedding.py``), as buffers; the
functions here update it in place or return new tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .tt_kernels import tt_fwd
from .tt_shapes import TTShapes


class CacheMeta(NamedTuple):
    """freq:  (N,) int32  LFU access counts
    ids:   (K,) int32  sorted cached node ids; -1 = empty slot
    ready: ()   bool   False until the first populate (warmup)"""

    freq: torch.Tensor
    ids: torch.Tensor
    ready: torch.Tensor


def init_meta(num_embeddings: int, cache_size: int, device=None) -> CacheMeta:
    return CacheMeta(
        freq=torch.zeros((num_embeddings,), dtype=torch.int32, device=device),
        ids=torch.full((cache_size,), -1, dtype=torch.int32, device=device),
        ready=torch.zeros((), dtype=torch.bool, device=device))


def update_freq(meta: CacheMeta, indices: torch.Tensor) -> CacheMeta:
    """Count one batch's accesses (duplicates included) into ``meta.freq``,
    in place."""
    idx = indices.reshape(-1).long()
    meta.freq.index_add_(0, idx, torch.ones_like(idx, dtype=meta.freq.dtype))
    return meta


def top_ids(freq: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` most accessed ids in ``jax.lax.top_k``'s order: counts
    descending, the lower id first among equal counts (a stable sort), as
    int32, -1 where the count is 0."""
    counts, order = torch.sort(freq, descending=True, stable=True)
    ids = order[:k].to(torch.int32)
    return torch.where(counts[:k] > 0, ids, torch.full_like(ids, -1))


def populate(shapes: TTShapes, cores: Sequence[torch.Tensor], meta: CacheMeta,
             cache_size: int, chunk: int = 8192) -> Tuple[CacheMeta, torch.Tensor]:
    """The top-``cache_size`` ids by count, sorted, and their rows from the
    TT chain (``tt_fwd`` over chunks of ``chunk`` ids; zero rows for empty
    slots): (new meta, (K, D) f32 rows).  The counts carry over."""
    ids, _ = torch.sort(top_ids(meta.freq, cache_size))
    safe = torch.clamp(ids, min=0)
    cores = [c.detach() for c in cores]
    rows = torch.cat([tt_fwd(shapes, cores, safe[i:i + chunk])
                      for i in range(0, cache_size, chunk)])
    weight = torch.where((ids >= 0)[:, None], rows, torch.zeros_like(rows))
    return CacheMeta(freq=meta.freq, ids=ids, ready=torch.ones_like(meta.ready)), weight


def lookup(meta: CacheMeta, indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hit (B,) bool, slot (B,) int64): binary search in the sorted id
    table; nothing hits before the first populate."""
    idx = indices.to(torch.int32)
    pos = torch.clamp(torch.searchsorted(meta.ids, idx), max=meta.ids.shape[0] - 1)
    hit = (meta.ids.index_select(0, pos) == idx) & meta.ready
    return hit, pos


def split_indices(meta: CacheMeta, indices: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tt_indices int32, hit, slot): the hits remapped to id 0 for the TT
    path, which the select in :func:`cached_forward` then discards."""
    hit, slot = lookup(meta, indices)
    idx = indices.to(torch.int32)
    return torch.where(hit, torch.zeros_like(idx), idx), hit, slot


def cached_forward(cache_weight: torch.Tensor, tt_rows: torch.Tensor,
                   hit: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The TT rows with the hits' rows taken from the cache; differentiable
    in both ``tt_rows`` and ``cache_weight``."""
    cached = cache_weight.index_select(0, slot)
    return torch.where(hit[:, None], cached, tt_rows)

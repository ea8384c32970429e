"""TTEmbeddingBag — TT-compressed node embeddings as a ``torch.nn.Module`` —
and the other embedding modules of ``falcon_ttdforgnns_tpu/nn/tt_embedding.py``:
:class:`DenseEmbedding` (the ``--no-tt`` table), :class:`AccessCountingEmbedding`
(``--access-counts``), :class:`FixedFeatureEmbedding` (frozen real features)
and :class:`TableBatchedTTEmbeddingBag` (``num_tables`` TT tables in one
module).

Port of ``falcon_ttdforgnns_tpu/nn/tt_embedding.py:TTEmbeddingBag``.  The
cores are parameters ``tt_core_k`` of shape ``(p_k, r_k, q_k, r_{k+1})``.
The lookup picks its path by device, as the JAX module's ``kernel="auto"``
does by backend: on CUDA it runs the Hopper kernels through
:class:`TTLookup` (2-4 cores, which is every shape ``TTShapes`` admits);
on the CPU the plain chunked lookup.

With ``cache_size`` K > 0 the module keeps the LFU hot-row cache
(``ops/cache.py``): the parameter ``cache_weight`` (K, D), and its
metadata as buffers ``cache_freq`` (N,) int32, ``cache_ids`` (K,) int32
(sorted, -1 in empty slots) and ``cache_ready`` (bool).  A forward splits
the ids: hits read their row from ``cache_weight``, the rest go through the
TT lookup (the hits as id 0, discarded).  With ``device_freq`` a forward
that counts accesses adds its ids to ``cache_freq`` (``--mode puregpu``,
whose host loader never runs); otherwise the host loader counts, and
:meth:`cache_populate` takes its counts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import cache as cache_ops
from ..ops import tt_init
from ..ops.tt_kernels import tt_lookup_fused
from ..ops.tt_lookup import tt_lookup_batched
from ..ops.tt_shapes import TTShapes, make_tt_shapes


def init_cores(shapes: TTShapes, weight_dist: str, seed: int) -> Tuple[np.ndarray, ...]:
    """Core k comes from ``init_tt_cores(seed + 7919 * k)[k]`` — the JAX
    module's per-core seed offset, so both packages start from the same
    cores."""
    return tuple(tt_init.init_tt_cores(shapes, weight_dist, seed=seed + 7919 * k)[k]
                 for k in range(shapes.ndim))


def _pool(rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """EmbeddingBag sum-pooling over CSR ``offsets`` bag boundaries."""
    positions = torch.arange(rows.shape[0], device=rows.device)
    rowidx = torch.searchsorted(offsets[1:-1].to(positions.dtype), positions, right=True)
    out = torch.zeros((offsets.shape[0] - 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, rowidx, rows)


class TTEmbeddingBag(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 tt_ranks: Sequence[int] = (16, 16),
                 p_shapes: Optional[Sequence[int]] = None,
                 q_shapes: Optional[Sequence[int]] = None,
                 weight_dist: str = "approx-normal", cache_size: int = 0,
                 precomputed_cores: Optional[Sequence[np.ndarray]] = None,
                 init_seed: int = 0, batch_count: int = 131072,
                 device_freq: bool = False, device: Optional[torch.device] = None):
        super().__init__()
        self.shapes = make_tt_shapes(num_embeddings, embedding_dim, tuple(tt_ranks),
                                     p_shapes, q_shapes)
        self.batch_count = batch_count
        self.cache_size, self.device_freq = cache_size, device_freq
        cores = (precomputed_cores if precomputed_cores is not None
                 else init_cores(self.shapes, weight_dist, init_seed))
        for k, c in enumerate(cores):
            self.register_parameter(f"tt_core_{k}", nn.Parameter(
                torch.tensor(np.asarray(c, np.float32), device=device)))
        if cache_size > 0:
            self.cache_weight = nn.Parameter(torch.zeros(
                (cache_size, embedding_dim), dtype=torch.float32, device=device))
            meta = cache_ops.init_meta(num_embeddings, cache_size, device)
            self.register_buffer("cache_freq", meta.freq)
            self.register_buffer("cache_ids", meta.ids)
            self.register_buffer("cache_ready", meta.ready)

    @property
    def cores(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"tt_core_{k}") for k in range(self.shapes.ndim))

    @property
    def cache_meta(self) -> cache_ops.CacheMeta:
        return cache_ops.CacheMeta(self.cache_freq, self.cache_ids, self.cache_ready)

    def _lookup(self, indices: torch.Tensor) -> torch.Tensor:
        cores = self.cores
        if cores[0].is_cuda:
            return tt_lookup_fused(self.shapes, cores, indices.to(torch.int32))
        return tt_lookup_batched(self.shapes, cores, indices, self.batch_count)

    def forward(self, indices: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                count_accesses: bool = True) -> torch.Tensor:
        """indices (B,) -> (B, D), or (num_bags, D) with offsets.  With the
        cache: count the accesses (``device_freq`` and ``count_accesses``),
        split the ids into hits and the rest, look the rest up, and merge
        the hits' cached rows (JAX ``tt_embedding.py:150-175``)."""
        if self.cache_size > 0:
            meta = self.cache_meta
            if self.device_freq and count_accesses:
                cache_ops.update_freq(meta, indices)
            tt_idx, hit, slot = cache_ops.split_indices(meta, indices)
            rows = cache_ops.cached_forward(self.cache_weight, self._lookup(tt_idx), hit, slot)
        else:
            rows = self._lookup(indices)
        if offsets is not None:
            rows = _pool(rows, offsets)
        return rows

    @torch.no_grad()
    def cache_populate(self, freq: Optional[np.ndarray] = None) -> None:
        """Top-K populate (the warmup -> cached transition): install
        ``freq`` (the host loader's counts) as the counts if given, then
        refresh the id table from the counts and write the K rows of the TT
        chain into ``cache_weight``."""
        if self.cache_size <= 0:
            raise ValueError("cache_size == 0: no cache to populate")
        if freq is not None:
            self.cache_freq.copy_(torch.as_tensor(np.asarray(freq)))  # int64 counts to int32
        meta, weight = cache_ops.populate(self.shapes, self.cores, self.cache_meta,
                                          self.cache_size)
        self.cache_ids.copy_(meta.ids)
        self.cache_ready.copy_(meta.ready)
        self.cache_weight.copy_(weight)


class DenseEmbedding(nn.Module):
    """The plain (N, D) table of the no-TT baseline: ``weight`` drawn from
    N(0, 0.1^2) (the JAX module's ``normal(0.1)`` initialiser), rows by
    ``index_select``, sum-pooled over ``offsets`` when given.  Its gradient
    is the dense (N, D) scatter of the rows', as in JAX."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        weight = torch.empty((num_embeddings, embedding_dim), dtype=torch.float32)
        self.weight = nn.Parameter(weight.normal_(0.0, 0.1, generator=generator).to(device))

    def forward(self, indices: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                count_accesses: bool = True) -> torch.Tensor:
        rows = self.weight.index_select(0, indices)
        return rows if offsets is None else _pool(rows, offsets)


class AccessCountingEmbedding(nn.Module):
    """A :class:`DenseEmbedding` (the submodule ``table``) that counts each
    row's accesses in the int32 buffer ``counts`` when a forward counts
    accesses, duplicates included (JAX ``counts.at[indices].add(1)``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.register_buffer("counts", torch.zeros(num_embeddings, dtype=torch.int32,
                                                   device=device))
        self.table = DenseEmbedding(num_embeddings, embedding_dim, generator, device)

    def forward(self, indices: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                count_accesses: bool = True) -> torch.Tensor:
        if count_accesses:
            with torch.no_grad():
                self.counts.index_add_(0, indices, torch.ones_like(indices, dtype=torch.int32))
        return self.table(indices, offsets)


class FixedFeatureEmbedding(nn.Module):
    """Frozen real node features: the (N, D) buffer ``feats`` (f32), rows by
    ``index_select``, sum-pooled over ``offsets`` when given; nothing to
    train."""

    def __init__(self, features, device: Optional[torch.device] = None):
        super().__init__()
        self.register_buffer("feats", torch.as_tensor(
            np.asarray(features, np.float32), device=device))

    def forward(self, indices: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                count_accesses: bool = True) -> torch.Tensor:
        rows = self.feats.index_select(0, indices)
        return rows if offsets is None else _pool(rows, offsets)


class TableBatchedTTEmbeddingBag(nn.Module):
    """``num_tables`` TT tables in one module: indices (T, B) -> (T, B, D),
    with offsets (T, num_bags + 1) -> (T, num_bags, D).  One table delegates
    to :class:`TTEmbeddingBag` (the submodule ``tables``, cache included);
    more keep the cores ``tt_core_k`` (T, p_k, r_k, q_k, r_{k+1}), table t's
    drawn as the JAX module draws them (seed ``init_seed + 7919 k + 104729
    t``), and ignore ``cache_size``, as the reference does with several
    tables.  On the card each table's lookup is one ``tt_fwd`` (and one
    ``tt_grads`` in the backward); on the CPU the plain chunked lookup."""

    def __init__(self, num_tables: int, num_embeddings: int, embedding_dim: int,
                 tt_ranks: Sequence[int] = (16, 16),
                 p_shapes: Optional[Sequence[int]] = None,
                 q_shapes: Optional[Sequence[int]] = None,
                 weight_dist: str = "approx-normal", cache_size: int = 0,
                 init_seed: int = 0, batch_count: int = 131072,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.num_tables, self.batch_count = num_tables, batch_count
        if num_tables == 1:
            self.tables = TTEmbeddingBag(num_embeddings, embedding_dim, tt_ranks, p_shapes,
                                         q_shapes, weight_dist, cache_size,
                                         init_seed=init_seed, batch_count=batch_count,
                                         device=device)
            self.shapes = self.tables.shapes
            return
        self.shapes = make_tt_shapes(num_embeddings, embedding_dim, tuple(tt_ranks),
                                     p_shapes, q_shapes)
        for k in range(self.shapes.ndim):
            stacked = np.stack([tt_init.init_tt_cores(
                self.shapes, weight_dist, seed=init_seed + 7919 * k + 104729 * t)[k]
                for t in range(num_tables)]).astype(np.float32)
            self.register_parameter(f"tt_core_{k}", nn.Parameter(
                torch.tensor(stacked, device=device)))

    def forward(self, indices: torch.Tensor,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.num_tables == 1:
            return self.tables(indices[0], None if offsets is None else offsets[0])[None]
        cores = [getattr(self, f"tt_core_{k}") for k in range(self.shapes.ndim)]
        out = []
        for t in range(self.num_tables):
            cores_t = [c[t] for c in cores]
            if cores_t[0].is_cuda:
                rows = tt_lookup_fused(self.shapes, cores_t, indices[t].to(torch.int32))
            else:
                rows = tt_lookup_batched(self.shapes, cores_t, indices[t], self.batch_count)
            out.append(rows if offsets is None else _pool(rows, offsets[t]))
        return torch.stack(out)

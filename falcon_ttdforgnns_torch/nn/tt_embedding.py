"""TTEmbeddingBag — TT-compressed node embeddings as a ``torch.nn.Module``.

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

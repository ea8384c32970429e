"""TTEmbeddingBag — TT-compressed node embeddings as a ``torch.nn.Module``.

Port of ``falcon_ttdforgnns_tpu/nn/tt_embedding.py:TTEmbeddingBag`` without
the hot-row cache and the grouped lookup.  The cores are parameters
``tt_core_k`` of shape ``(p_k, r_k, q_k, r_{k+1})``.  The lookup picks its
path by device, as the JAX module's ``kernel="auto"`` does by backend: on
CUDA it runs the Hopper kernels through :class:`TTLookup` (2-4 cores, which
is every shape ``TTShapes`` admits); on the CPU the plain chunked lookup.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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
                 grouped: bool = False,
                 precomputed_cores: Optional[Sequence[np.ndarray]] = None,
                 init_seed: int = 0, batch_count: int = 131072,
                 device: Optional[torch.device] = None):
        super().__init__()
        if cache_size > 0:
            raise NotImplementedError("the hot-row cache is not ported yet "
                                      "(ROADMAP A6)")
        if grouped:
            raise NotImplementedError("the grouped lookup (--emb-name eff) is "
                                      "not ported yet (ROADMAP A6)")
        self.shapes = make_tt_shapes(num_embeddings, embedding_dim, tuple(tt_ranks),
                                     p_shapes, q_shapes)
        self.batch_count = batch_count
        cores = (precomputed_cores if precomputed_cores is not None
                 else init_cores(self.shapes, weight_dist, init_seed))
        for k, c in enumerate(cores):
            self.register_parameter(f"tt_core_{k}", nn.Parameter(
                torch.tensor(np.asarray(c, np.float32), device=device)))

    @property
    def cores(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"tt_core_{k}") for k in range(self.shapes.ndim))

    def forward(self, indices: torch.Tensor,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices (B,) -> (B, D), or (num_bags, D) with offsets."""
        cores = self.cores
        if cores[0].is_cuda:
            rows = tt_lookup_fused(self.shapes, cores, indices.to(torch.int32))
        else:
            rows = tt_lookup_batched(self.shapes, cores, indices, self.batch_count)
        if offsets is not None:
            rows = _pool(rows, offsets)
        return rows

"""GraphSAGE with TT-compressed node embeddings (f32 tower).

Port of ``falcon_ttdforgnns_tpu/models/sage.py``.  Training runs on the
sampler's dense-fanout tensors (reshape + mean aggregation); evaluation is
full-graph propagation over the COO edge list.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.layers import SAGEConv
from ..nn.tt_embedding import TTEmbeddingBag
from ..ops.segment import spmm_mean


def collect_level_ids(seeds: torch.Tensor, layers: Sequence[torch.Tensor]):
    """Flattened ids over every fanout level — seeds first, then each level
    flattened — plus the per-level widths and B.  Duplicates included."""
    B = seeds.shape[0]
    levels = [seeds.reshape(B, 1)] + [l.reshape(B, -1) for l in layers]
    sizes = [lv.shape[1] for lv in levels]
    all_ids = torch.cat([lv.reshape(-1) for lv in levels])
    return all_ids, sizes, B


def dropout(h: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator (flax ``nn.Dropout``
    semantics: keep with prob 1-p, scale kept values by 1/(1-p))."""
    if not train or p == 0.0:
        return h
    keep = 1.0 - p
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


class SAGE(nn.Module):
    def __init__(self, num_nodes: int, in_dim: int, hidden_dim: int,
                 num_classes: int, num_layers: int = 3, dropout: float = 0.5,
                 tt_ranks: Sequence[int] = (16, 16),
                 p_shapes: Optional[Sequence[int]] = None,
                 q_shapes: Optional[Sequence[int]] = None,
                 weight_dist: str = "approx-normal", cache_size: int = 0,
                 precomputed_cores: Optional[Sequence[np.ndarray]] = None,
                 batch_count: int = 131072, grouped: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_nodes, self.in_dim = num_nodes, in_dim
        self.num_layers, self.dropout = num_layers, dropout
        self.embed = TTEmbeddingBag(
            num_nodes, in_dim, tt_ranks, p_shapes, q_shapes, weight_dist,
            cache_size, grouped, precomputed_cores, batch_count=batch_count)
        dims = [hidden_dim] * (num_layers - 1) + [num_classes]
        ins = [in_dim] + dims[:-1]
        self.convs = nn.ModuleList(SAGEConv(i, o, generator=generator)
                                   for i, o in zip(ins, dims))

    def forward(self, seeds: torch.Tensor, layers: Sequence[torch.Tensor],
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dense-fanout forward: one embedding lookup over every level."""
        all_ids, sizes, B = collect_level_ids(seeds, layers)
        hs = self._split_levels(self.embed(all_ids), sizes, B)
        return self._conv_tower(hs, train, generator)

    def _split_levels(self, h_all: torch.Tensor, sizes: Sequence[int],
                      B: int) -> List[torch.Tensor]:
        hs, off = [], 0
        for sz in sizes:
            hs.append(h_all[off:off + sz * B].reshape(B, sz, self.in_dim))
            off += sz * B
        return hs

    def _conv_tower(self, hs: List[torch.Tensor], train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        B = hs[0].shape[0]
        for li, conv in enumerate(self.convs):
            new_hs = []
            for lev in range(len(hs) - 1):
                n, f = hs[lev].shape[1], hs[lev + 1].shape[1] // hs[lev].shape[1]
                h_neigh = hs[lev + 1].reshape(B, n, f, -1).mean(dim=2)
                h = conv(hs[lev], h_neigh)
                if li < self.num_layers - 1:
                    h = dropout(torch.relu(h), self.dropout, train, generator)
                new_hs.append(h)
            hs = new_hs
        return hs[0][:, 0, :]  # (B, num_classes)

    def forward_from_embeddings(self, h_all: torch.Tensor, seeds: torch.Tensor,
                                layers: Sequence[torch.Tensor], train: bool = False,
                                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward with the lookup hoisted out: ``h_all`` holds the rows of
        :func:`collect_level_ids`'s ids (the fused-sparse train step)."""
        B = seeds.shape[0]
        sizes = [1] + [l.reshape(B, -1).shape[1] for l in layers]
        return self._conv_tower(self._split_levels(h_all, sizes, B), train, generator)

    def forward_full_graph(self, src: torch.Tensor, dst: torch.Tensor,
                           in_deg: torch.Tensor, train: bool = False,
                           chunk: int = 1 << 22,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of every node by full-graph propagation (exact
        aggregation over every edge)."""
        ids = torch.arange(self.num_nodes, dtype=torch.int32, device=src.device)
        h = self.embed(ids)
        for li, conv in enumerate(self.convs):
            h = conv(h, spmm_mean(h, src, dst, self.num_nodes, in_deg, chunk=chunk))
            if li < self.num_layers - 1:
                h = dropout(torch.relu(h), self.dropout, train, generator)
        return h  # (N, num_classes)

    def apply_conv(self, h_dst: torch.Tensor, h_neigh: torch.Tensor,
                   layer_idx: int) -> torch.Tensor:
        h = self.convs[layer_idx](h_dst, h_neigh)
        return torch.relu(h) if layer_idx < self.num_layers - 1 else h

    def materialize_features(self, node_ids: torch.Tensor) -> torch.Tensor:
        return self.embed(node_ids)

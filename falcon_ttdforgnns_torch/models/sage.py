"""GraphSAGE with TT-compressed node embeddings.

Port of ``falcon_ttdforgnns_tpu/models/sage.py``.  Training runs on the
sampler's dense-fanout tensors (reshape + mean aggregation); evaluation is
full-graph propagation over the COO edge list.

``bf16`` (``--bf16``/``--bf16-tower``) runs the conv tower in bfloat16:
every level is cast, the convs compute in bf16 (params stay f32), and the
logits are cast back to f32.  ``bf16_f32_head``/``bf16_f32_first`` run the
last/first conv in f32 instead.  The bf16 fan-out means are the JAX
package's ``mean(dtype=bfloat16)`` bit for bit (:func:`fanout_mean_bf16`:
partial sums rounded to bf16, one kernel on the card), and
``mean_acc_f32`` takes them as ``mean(dtype=float32)`` cast back to bf16,
the reference's f32 accumulator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.layers import SAGEConv, dropout
from ..nn.tt_embedding import (AccessCountingEmbedding, DenseEmbedding,
                               FixedFeatureEmbedding, TTEmbeddingBag)
from ..ops.segment import VECTOR, FullGraph
from ..ops.tower import fanout_mean_bf16
from ..utils.metrics import span


def make_embed_layer(num_nodes: int, feat_dim: int, use_tt: bool = True,
                     tt_ranks: Sequence[int] = (16, 16),
                     p_shapes: Optional[Sequence[int]] = None,
                     q_shapes: Optional[Sequence[int]] = None,
                     weight_dist: str = "approx-normal", cache_size: int = 0,
                     access_counts: bool = False, precomputed_cores=None,
                     fixed_features=None, batch_count: int = 131072,
                     device_freq: bool = False,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """The embedding layer, chosen in the JAX package's order
    (``models/sage.py:make_embed_layer``): frozen features when given, else
    the TT embedding, else the access-counting dense table under
    ``access_counts``, else the dense table (drawn from ``generator``)."""
    if fixed_features is not None:
        return FixedFeatureEmbedding(fixed_features)
    if use_tt:
        return TTEmbeddingBag(num_nodes, feat_dim, tt_ranks, p_shapes, q_shapes,
                              weight_dist, cache_size, precomputed_cores,
                              batch_count=batch_count, device_freq=device_freq)
    if access_counts:
        return AccessCountingEmbedding(num_nodes, feat_dim, generator)
    return DenseEmbedding(num_nodes, feat_dim, generator)


def collect_level_ids(seeds: torch.Tensor, layers: Sequence[torch.Tensor]):
    """Flattened ids over every fanout level — seeds first, then each level
    flattened — plus the per-level widths and B.  Duplicates included."""
    B = seeds.shape[0]
    levels = [seeds.reshape(B, 1)] + [l.reshape(B, -1) for l in layers]
    sizes = [lv.shape[1] for lv in levels]
    all_ids = torch.cat([lv.reshape(-1) for lv in levels])
    return all_ids, sizes, B


class SAGE(nn.Module):
    def __init__(self, num_nodes: int, in_dim: int, hidden_dim: int,
                 num_classes: int, num_layers: int = 3, dropout: float = 0.5,
                 use_tt: bool = True, tt_ranks: Sequence[int] = (16, 16),
                 p_shapes: Optional[Sequence[int]] = None,
                 q_shapes: Optional[Sequence[int]] = None,
                 weight_dist: str = "approx-normal", cache_size: int = 0,
                 access_counts: bool = False,
                 precomputed_cores: Optional[Sequence[np.ndarray]] = None,
                 batch_count: int = 131072,
                 generator: Optional[torch.Generator] = None, bf16: bool = False,
                 mean_acc_f32: bool = False, bf16_f32_head: bool = False,
                 bf16_f32_first: bool = False, device_freq: bool = False):
        super().__init__()
        self.num_nodes, self.in_dim = num_nodes, in_dim
        self.num_layers, self.dropout = num_layers, dropout
        self.bf16, self.mean_acc_f32 = bf16, mean_acc_f32
        self.embed = make_embed_layer(
            num_nodes, in_dim, use_tt, tt_ranks, p_shapes, q_shapes, weight_dist,
            cache_size, access_counts, precomputed_cores, batch_count=batch_count,
            device_freq=device_freq, generator=generator)
        dims = [hidden_dim] * (num_layers - 1) + [num_classes]
        ins = [in_dim] + dims[:-1]

        def layer_dtype(i):  # JAX models/sage.py:121-126
            if not bf16 or (bf16_f32_head and i == len(dims) - 1) or (
                    bf16_f32_first and i == 0):
                return None  # f32 params; a bf16 input is promoted
            return torch.bfloat16

        self.convs = nn.ModuleList(
            SAGEConv(i, o, generator=generator, dtype=layer_dtype(li))
            for li, (i, o) in enumerate(zip(ins, dims)))

    def forward(self, seeds: torch.Tensor, layers: Sequence[torch.Tensor],
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dense-fanout forward: one embedding lookup over every level; a
        training forward counts its accesses for the cache."""
        all_ids, sizes, B = collect_level_ids(seeds, layers)
        with span("embed.lookup"):
            h_all = self.embed(all_ids, count_accesses=train)
        return self._conv_tower(self._split_levels(h_all, sizes, B), train, generator)

    def _split_levels(self, h_all: torch.Tensor, sizes: Sequence[int],
                      B: int) -> List[torch.Tensor]:
        hs, off = [], 0
        for sz in sizes:
            hs.append(h_all[off:off + sz * B].reshape(B, sz, self.in_dim))
            off += sz * B
        return hs

    def _conv_tower(self, hs: List[torch.Tensor], train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        with span("tower.fwd"):
            B = hs[0].shape[0]
            if self.bf16:
                hs = [h.to(torch.bfloat16) for h in hs]
            for li, conv in enumerate(self.convs):
                new_hs = []
                for lev in range(len(hs) - 1):
                    n, f = hs[lev].shape[1], hs[lev + 1].shape[1] // hs[lev].shape[1]
                    nb = hs[lev + 1].reshape(B, n, f, -1)
                    if nb.dtype != torch.bfloat16:
                        h_neigh = nb.mean(dim=2)
                    elif self.mean_acc_f32:
                        h_neigh = nb.mean(dim=2, dtype=torch.float32).to(nb.dtype)
                    else:
                        h_neigh = fanout_mean_bf16(nb)
                    h = conv(hs[lev], h_neigh)
                    if li < self.num_layers - 1:
                        h = dropout(torch.relu(h), self.dropout, train, generator)
                    new_hs.append(h)
                hs = new_hs
            return hs[0][:, 0, :].float()  # (B, num_classes)

    def forward_from_embeddings(self, h_all: torch.Tensor, seeds: torch.Tensor,
                                layers: Sequence[torch.Tensor], train: bool = False,
                                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward with the lookup hoisted out: ``h_all`` holds the rows of
        :func:`collect_level_ids`'s ids (the fused-sparse train step)."""
        B = seeds.shape[0]
        sizes = [1] + [l.reshape(B, -1).shape[1] for l in layers]
        return self._conv_tower(self._split_levels(h_all, sizes, B), train, generator)

    def forward_full_graph(self, graph: FullGraph, train: bool = False,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of every node by full-graph propagation (exact
        aggregation over every edge of ``graph``).  Each conv keeps its
        dtype here, as the JAX convs do: under ``bf16`` the activations
        after the first conv, their SpMM and the logits are bf16.

        A conv whose neighbour product is narrower than its input (padded to
        16-byte rows: the last conv, 256 -> 47 padded to 48), where the mean
        needs no gradient, takes its mean after the product, not before it:
        the mean is linear, and it then gathers the narrow rows.  That mean
        sums in f32 and rounds once (:meth:`FullGraph.projected_mean`), so
        such a layer gives up the JAX package's bits for a result within
        bf16 tolerance of them; every other layer keeps its order and bits."""
        with span("embed.lookup"):
            h = self.embed(torch.arange(self.num_nodes, dtype=torch.int32,
                                        device=graph.src.device), count_accesses=train)
        for li, conv in enumerate(self.convs):
            width = self._product_width(conv, h)
            if width:
                with span("tower.conv"):
                    p = conv.neigh_product(h, width)
                with span("spmm.aggregate"):
                    agg = graph.projected_mean(p, h.dtype)
                del p
            else:
                with span("spmm.aggregate"):
                    agg = graph.mean(h)
            with span("tower.conv"):
                h = conv.finish(h, agg) if width else conv(h, agg)
                if li < self.num_layers - 1:
                    h = dropout(torch.relu(h), self.dropout, train, generator)
        return h  # (N, num_classes)

    @staticmethod
    def _product_width(conv: SAGEConv, h: torch.Tensor) -> int:
        """The width of ``conv``'s neighbour product of ``h`` padded to whole
        16-byte rows where its mean is to be taken after the product: where
        that is narrower than ``h`` and the product needs no gradient; else
        0."""
        w = conv.lin_neigh.weight
        if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
            return 0
        dt = conv.dtype or torch.promote_types(h.dtype, w.dtype)
        width = w.shape[0] + -w.shape[0] % VECTOR[dt]
        return width if width < h.shape[1] else 0

    def apply_conv(self, h_dst: torch.Tensor, h_neigh: torch.Tensor,
                   layer_idx: int) -> torch.Tensor:
        """One conv layer given the aggregated neighbour features."""
        with span("tower.conv"):
            h = self.convs[layer_idx](h_dst, h_neigh)
            return torch.relu(h) if layer_idx < self.num_layers - 1 else h

    def materialize_features(self, node_ids: torch.Tensor) -> torch.Tensor:
        """Rows of the feature table (cache hits from the cache); counts no
        access."""
        with span("embed.lookup"):
            return self.embed(node_ids, count_accesses=False)

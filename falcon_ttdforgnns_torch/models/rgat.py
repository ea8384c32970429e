"""Heterogeneous relational GAT: port of
``falcon_ttdforgnns_tpu/models/rgat.py`` (a re-design of the reference's
``gnn_model.py:515-595``), MAG-style: one :class:`GATConv` bank per edge
type with a skip connection, on a typed COO edge list (one (src, dst) pair
per edge type).  Each conv is the port's GAT layer without its residual
branch, so the per-type attention runs the same chunked aggregation
(``headed_spmm``) as the full-graph GAT.  ``convert.rgat_state_from_jax``
carries the flax params in.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.layers import GATConv, dense, dropout

TypedEdges = Sequence[Tuple[torch.Tensor, torch.Tensor]]


class RGATLayer(nn.Module):
    """Per-type attention, the mean over the types, plus a skip Dense of
    the input; relu, then dropout.  ``out_dim`` is per head."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, num_etypes: int,
                 dropout: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList(
            GATConv(in_dim, out_dim, num_heads, residual=False, generator=generator)
            for _ in range(num_etypes))
        self.skip = dense(in_dim, out_dim * num_heads, True, generator)

    def forward(self, h: torch.Tensor, typed_edges: TypedEdges,
                in_degs: Sequence[torch.Tensor], num_nodes: int, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        outs = [conv(h, src, dst, deg, num_nodes, train, generator)
                for conv, (src, dst), deg in zip(self.convs, typed_edges, in_degs, strict=True)]
        out = torch.relu(torch.stack(outs).mean(0) + self.skip(h))
        return dropout(out, self.dropout, train, generator)


class RGAT(nn.Module):
    """``num_layers`` :class:`RGATLayer` of ``num_heads`` x ``hidden_dim``,
    then a Dense to the classes; the per-type in-degrees are counted from
    the edges on each call."""

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int, num_etypes: int,
                 num_layers: int = 2, num_heads: int = 2, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = hidden_dim * num_heads
        self.layers = nn.ModuleList(
            RGATLayer(in_dim if i == 0 else width, hidden_dim, num_heads, num_etypes,
                      dropout, generator)
            for i in range(num_layers))
        self.out = dense(width, num_classes, True, generator)

    def forward(self, feat: torch.Tensor, typed_edges: TypedEdges, num_nodes: int,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        in_degs = [torch.bincount(dst, minlength=num_nodes).to(torch.float32)
                   for _, dst in typed_edges]
        h = feat
        for layer in self.layers:
            h = layer(h, typed_edges, in_degs, num_nodes, train, generator)
        return self.out(h)

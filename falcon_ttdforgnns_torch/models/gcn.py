"""Full-graph GCN (port of ``falcon_ttdforgnns_tpu/models/gcn.py``): a
GraphConv stack with an optional parallel linear branch, batch norm, ReLU
and dropout between the layers."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import BatchNorm, GraphConv, dense, dropout
from ..ops.spmm_blocked import BlockedSpmm


class GCN(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int = 3, dropout: float = 0.5, use_linear: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        outs = [hidden_dim] * (num_layers - 1) + [num_classes]
        ins = [in_dim] + outs[:-1]
        self.convs = nn.ModuleList(GraphConv(i, o, generator=generator)
                                   for i, o in zip(ins, outs))
        self.linears = (nn.ModuleList(dense(i, o, False, generator) for i, o in zip(ins, outs))
                        if use_linear else None)
        self.bns = nn.ModuleList(BatchNorm(o) for o in outs[:-1])

    def forward(self, feat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                in_deg: torch.Tensor, train: bool = False,
                blocked: Optional[BlockedSpmm] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = feat.shape[0]
        h = feat
        for i, conv in enumerate(self.convs):
            out = conv(h, src, dst, in_deg, n, blocked)
            if self.linears is not None:
                out = out + self.linears[i](h)
            h = out
            if i < self.num_layers - 1:
                h = torch.relu(self.bns[i](h, train))
                h = dropout(h, self.dropout, train, generator)
        return h

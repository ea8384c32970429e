"""Full-graph GAT (port of ``falcon_ttdforgnns_tpu/models/gat.py``): a
GATConv stack (one head on the last layer) with an optional parallel linear
branch, batch norm, ReLU and dropout between the layers, and a trailing
bias."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import BatchNorm, Bias, GATConv, dense, dropout


class GAT(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int = 3, num_heads: int = 3, dropout: float = 0.5,
                 attn_dropout: float = 0.05, use_linear: bool = False,
                 use_symmetric_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        heads = [num_heads] * (num_layers - 1) + [1]
        outs = [hidden_dim] * (num_layers - 1) + [num_classes]
        ins = [in_dim] + [o * hd for o, hd in zip(outs[:-1], heads[:-1])]
        self.convs = nn.ModuleList(
            GATConv(i, o, num_heads=hd, use_symmetric_norm=use_symmetric_norm,
                    attn_dropout=attn_dropout, generator=generator)
            for i, o, hd in zip(ins, outs, heads))
        self.linears = (nn.ModuleList(dense(i, o * hd, False, generator)
                                      for i, o, hd in zip(ins, outs, heads))
                        if use_linear else None)
        self.bns = nn.ModuleList(BatchNorm(o * hd) for o, hd in zip(outs[:-1], heads[:-1]))
        self.bias_last = Bias(num_classes)

    def forward(self, feat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                in_deg: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = feat.shape[0]
        h = feat
        for i, conv in enumerate(self.convs):
            out = conv(h, src, dst, in_deg, n, train, generator)
            if self.linears is not None:
                out = out + self.linears[i](h)
            h = out
            if i < self.num_layers - 1:
                h = torch.relu(self.bns[i](h, train))
                h = dropout(h, self.dropout, train, generator)
        return self.bias_last(h)

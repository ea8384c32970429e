"""GAT with neighbour sampling over TT-compressed node embeddings: OGB's
ogbn-products entry "GAT (NeighborSampling)", PyTorch Geometric's
``examples/ogbn_products_gat.py`` (Velickovic et al., ICLR 2018).

This model is the port's own: the JAX package has no sampled GAT (its
``models/gat.py`` is the full-graph arxiv recipe, ``models/gat.py`` here).
It keeps :class:`models.sage.SAGE`'s interface, which the trainer reaches
it through: ``forward`` and ``forward_from_embeddings`` on the sampler's
dense-fanout levels, ``_conv_tower``, ``forward_full_graph`` for
layer-wise evaluation, ``materialize_features`` and ``embed``.

Layer l (:class:`GATNSConv`) maps h to

    x = h W^T                         W (H C, in), no bias, for source and target
    el = <x, a_src>, er = <x, a_dst>  per head, (., H)
    s_uv = leaky_relu(el[u] + er[v], 0.2)
    alpha = softmax of s over v's in-edges and its self-loop
    out_v = concat_h or mean_h (sum_u alpha_uv x_u) + b + skip(h_v)
    h' = dropout(elu(out), p)         not after the last layer

with the heads concatenated on every layer but the last, whose heads are
averaged into the classes, and ``skip`` a linear map with bias.

Training runs on the sampler's levels: level ``lev`` holds each slot's f
children in level ``lev + 1``, and each destination slot's softmax runs
over its f sampled slots and its own slot, duplicates included, as plain
torch ops under autograd.  Evaluation walks each row's in-edges through
:func:`ops.attention.csr_gat`, one call a layer, over the row index of
the trainer's :class:`ops.segment.FullGraph`; a head's width is padded
there to the kernel's 16-byte loads with zero weights.

``bf16`` runs the rows, the products and the activations in bfloat16
(the parameters stay f32 and are cast); el, er, the scores, the softmax
and the weighted sums run in f32 and are stored bf16; the logits come back
f32.  Each layer's skip takes both biases in its one product.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import dropout, lecun_normal_
from ..ops.attention import NEGATIVE_SLOPE, VECTOR, csr_gat
from ..ops.segment import FullGraph, RowIndex
from ..utils.metrics import span
from .sage import SAGE, make_embed_layer


class GATNSConv(nn.Module):
    """One GAT layer of the sampled model: ``fc`` (H C, in) without bias,
    the attention vectors ``att_src``, ``att_dst`` (H, C), ``bias`` (H C,
    or C when the heads are averaged), and ``skip``, a linear map from the
    layer's input to its output with bias.  ``dtype`` is the compute dtype
    (bf16 under ``--bf16``); None computes in f32."""

    def __init__(self, in_dim: int, out_dim: int, heads: int, concat: bool,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.out_dim, self.concat, self.dtype = heads, out_dim, concat, dtype
        width = heads * out_dim if concat else out_dim
        self.fc = nn.Linear(in_dim, heads * out_dim, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, out_dim))
        self.att_dst = nn.Parameter(torch.empty(heads, out_dim))
        self.bias = nn.Parameter(torch.zeros(width))
        self.skip = nn.Linear(in_dim, width)
        lecun_normal_(self.fc.weight, generator)
        lecun_normal_(self.skip.weight, generator)
        a = math.sqrt(6.0 / (heads + out_dim))  # PyG's glorot on (1, H, C)
        with torch.no_grad():
            for p in (self.att_src, self.att_dst):
                p.copy_((2 * torch.rand(p.shape, generator=generator) - 1) * a)
            nn.init.zeros_(self.skip.bias)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype or torch.promote_types(t.dtype, torch.float32))

    def project(self, h: torch.Tensor, pad: int = 0) -> Tuple[torch.Tensor, ...]:
        """x = h W^T (..., H (C + pad)) in the compute dtype, and el, er
        (..., H) in f32, each head's last ``pad`` columns zero."""
        h = self._cast(h)
        w, a = self.fc.weight, torch.stack([self.att_src, self.att_dst])
        if pad:
            w = F.pad(w.reshape(self.heads, self.out_dim, -1), (0, 0, 0, pad))
            w = w.reshape(-1, w.shape[-1])
            a = F.pad(a, (0, pad))
        x = h @ w.to(h.dtype).t()
        return (x, *attention_logits(x, a.to(h.dtype)))

    def finish(self, agg: torch.Tensor, h: torch.Tensor, pad: int = 0) -> torch.Tensor:
        """The skip of the layer's input with both biases (one product,
        rounded once), plus the aggregation, stored in the compute dtype; in
        place on the skip, whose product keeps no output for its gradient.
        ``pad`` zero columns after the output's, where ``agg`` has them."""
        h = self._cast(h)
        w, b, dt = self.skip.weight, self.skip.bias + self.bias, h.dtype
        if pad:
            w, b = F.pad(w, (0, 0, 0, pad)), F.pad(b, (0, pad))
        out = torch.addmm(b.to(dt), h.reshape(-1, h.shape[-1]), w.to(dt).t())
        return out.reshape(*h.shape[:-1], -1).add_(agg.to(dt))

    def attend_fanout(self, x_dst: torch.Tensor, x_nb: torch.Tensor, el_dst, er_dst,
                      el_nb) -> torch.Tensor:
        """The sampled attention of one level: destination slots (B, n, H C)
        and their children (B, n f, H C); each slot's softmax over its f
        children and itself, in f32; (B, n, H C) or the head mean (B, n, C),
        stored in x's dtype."""
        B, n, H, C = x_dst.shape[0], x_dst.shape[1], self.heads, self.out_dim
        f = x_nb.shape[1] // n
        s = torch.cat([(el_dst + er_dst)[:, :, None],
                       el_nb.reshape(B, n, f, H) + er_dst[:, :, None]], dim=2)
        alpha = torch.softmax(F.leaky_relu(s, NEGATIVE_SLOPE), dim=2)  # (B, n, 1 + f, H)
        xs = torch.cat([x_dst.reshape(B, n, 1, H, C), x_nb.reshape(B, n, f, H, C)], dim=2)
        out = torch.einsum("bnkh,bnkhc->bnhc", alpha, xs.float())
        out = out.reshape(B, n, H * C) if self.concat else out.mean(2)
        return out.to(x_dst.dtype)


def attention_logits(x: torch.Tensor, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """el, er (..., H) f32 of x (..., H C) and the attention vectors ``a``
    (2, H, C) in x's dtype: each head's dot product in f32, as one product
    by the block-diagonal (H C, 2 H) matrix of ``a``.  On the card a bf16 x
    meets it in a bf16 GEMM with f32 output (its products are exact, its
    sums f32); elsewhere x is read in f32."""
    H, C = a.shape[1], a.shape[2]
    eye = torch.eye(H, dtype=a.dtype, device=a.device)
    blk = torch.cat([(a[i][:, :, None] * eye[:, None, :]).reshape(H * C, H) for i in (0, 1)], 1)
    x2 = x.reshape(-1, H * C)
    if x2.is_cuda and x2.dtype == torch.bfloat16 and not torch.is_grad_enabled():
        e = torch.mm(x2, blk, out_dtype=torch.float32)
    else:
        e = x2.float() @ blk.float()
    e = e.reshape(*x.shape[:-1], 2 * H)
    return e[..., :H], e[..., H:]


class GATNS(nn.Module):
    """Sampled GAT over the embedding table: ``num_layers`` layers of
    ``num_heads`` heads of ``hidden_dim`` (concatenated), the last's heads
    averaged into ``num_classes``."""

    # the level plumbing is SAGE's own: one lookup over every level, split
    # into levels, then this model's tower
    forward = SAGE.forward
    forward_from_embeddings = SAGE.forward_from_embeddings
    _split_levels = SAGE._split_levels
    materialize_features = SAGE.materialize_features

    def __init__(self, num_nodes: int, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int = 3, num_heads: int = 4, dropout: float = 0.5,
                 use_tt: bool = True, tt_ranks: Sequence[int] = (16, 16),
                 p_shapes: Optional[Sequence[int]] = None,
                 q_shapes: Optional[Sequence[int]] = None,
                 weight_dist: str = "approx-normal", cache_size: int = 0,
                 access_counts: bool = False,
                 precomputed_cores: Optional[Sequence[np.ndarray]] = None,
                 batch_count: int = 131072,
                 generator: Optional[torch.Generator] = None, bf16: bool = False,
                 device_freq: bool = False):
        super().__init__()
        self.num_nodes, self.in_dim = num_nodes, in_dim
        self.num_layers, self.dropout, self.bf16 = num_layers, dropout, bf16
        self.embed = make_embed_layer(
            num_nodes, in_dim, use_tt, tt_ranks, p_shapes, q_shapes, weight_dist,
            cache_size, access_counts, precomputed_cores, batch_count=batch_count,
            device_freq=device_freq, generator=generator)
        outs = [hidden_dim] * (num_layers - 1) + [num_classes]
        ins = [in_dim] + [num_heads * hidden_dim] * (num_layers - 1)
        self.convs = nn.ModuleList(
            GATNSConv(i, o, num_heads, li < num_layers - 1, generator,
                      torch.bfloat16 if bf16 else None)
            for li, (i, o) in enumerate(zip(ins, outs)))

    def _conv_tower(self, hs: List[torch.Tensor], train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        with span("tower.fwd"):
            if self.bf16:
                hs = [h.to(torch.bfloat16) for h in hs]
            for li, conv in enumerate(self.convs):
                proj = [conv.project(h) for h in hs]  # every level: the deepest as sources
                new_hs = []
                for lev in range(len(hs) - 1):
                    (x, el, er), (x_nb, el_nb, _) = proj[lev], proj[lev + 1]
                    with span("attn.fanout"):
                        agg = conv.attend_fanout(x, x_nb, el, er, el_nb)
                    h = conv.finish(agg, hs[lev])
                    if li < self.num_layers - 1:
                        h = dropout(F.elu(h), self.dropout, train, generator)
                    new_hs.append(h)
                hs = new_hs
            return hs[0][:, 0, :].float()  # (B, num_classes)

    def forward_full_graph(self, graph: FullGraph, train: bool = False,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits (f32) of every node by layer-wise full-graph propagation
        over every in-edge of ``graph``: the lookup of every row, then
        :meth:`_full_layer` a layer through the graph's row index.  Forward
        only."""
        if train or torch.is_grad_enabled():
            raise ValueError("the sampled GAT's full-graph forward is forward only: "
                             "train it on sampled levels")
        with span("embed.lookup"):
            h = self.embed(torch.arange(self.num_nodes, dtype=torch.int32,
                                        device=graph.src.device), count_accesses=False)
        for li in range(self.num_layers):
            h = self._full_layer(h, li, graph.index())
        return h.float()[:, :self.convs[-1].out_dim]

    def _full_layer(self, h: torch.Tensor, li: int, index: RowIndex) -> torch.Tensor:
        """Layer ``li`` over every in-edge and self-loop: the projection with
        each head padded to the kernel's 16-byte loads, the attention, then
        the skip with both biases plus the attention's result and, but after
        the last layer, ELU.  The averaged heads (the last layer) keep their
        padding, zero, to the end: the sum then runs over whole 16-byte
        rows."""
        conv = self.convs[li]
        pad = -conv.out_dim % VECTOR[conv.dtype or torch.float32]
        with span("tower.conv"):
            x, el, er = conv.project(h, pad)
        with span("attn.aggregate"):
            agg = csr_gat(x, el, er, index, conv.heads, not conv.concat)
        del x, el, er
        if pad and conv.concat:  # the heads side by side: drop each head's padding
            n, cp = agg.shape[0], conv.out_dim + pad
            agg = agg.reshape(n, conv.heads, cp)[..., :conv.out_dim].reshape(n, -1)
        with span("tower.conv"):
            h = conv.finish(agg, h, 0 if conv.concat else pad)
            return F.elu_(h) if li < self.num_layers - 1 else h

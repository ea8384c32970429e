"""Graph-property (molecular) GNN stack with a virtual node: port of
``falcon_ttdforgnns_tpu/models/gin.py`` (a re-design of the reference's
OGB mol stack, ``gnn_model.py:599-983``): bond-feature encoders, GIN or
degree-normalised GCN convolutions, an optional virtual-node channel, and
five graph poolings (sum, mean, max, gated attention, Set2Set).

A batch of G small graphs is one COO edge list with a ``graph_id`` per
node; pooling is a segment operation over ``graph_id``, and edge features
ride along the edge list.  The layers keep flax's semantics: ``BatchNorm``
is the port's flax-semantics layer (``nn/layers.py``), and Set2Set's LSTM
cells are ``torch.nn.LSTMCell`` holding flax's ``LSTMCell`` gates (see
:class:`Set2Set`).  An empty segment's max (a padding graph) is -inf in
the segment max and taken as 0, as in the reference.
``convert.mol_gnn_state_from_jax`` carries the flax params and batch
statistics in.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.layers import BatchNorm, dense, dropout, lecun_normal_

BOND_DIMS = (5, 6, 2)  # the cardinalities of OGB's three bond features


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    return x.new_zeros((num,) + tuple(x.shape[1:])).index_add_(0, seg, x)


def segment_max(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Each segment's max, an empty segment's 0 (its -inf replaced); at
    ties the gradient is shared evenly among the tied rows, as JAX's."""
    idx = seg.view(-1, *[1] * (x.dim() - 1)).expand_as(x)
    m = x.new_full((num,) + tuple(x.shape[1:]), float("-inf")).scatter_reduce(
        0, idx, x, reduce="amax", include_self=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def segment_softmax(e: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Softmax of (N, 1) scores within each segment: the max subtracted
    (detached: the softmax does not depend on it), the sum floored at 1e-9."""
    ex = torch.exp(e - segment_max(e.detach(), seg, num).index_select(0, seg))
    return ex / torch.clamp(segment_sum(ex, seg, num).index_select(0, seg), min=1e-9)


class BondEncoder(nn.Module):
    """The sum of one embedding per integer bond feature (``gnn_model.py:599-616``;
    the cardinalities are an argument, not read from ogb)."""

    def __init__(self, emb_dim: int, feature_dims: Sequence[int] = BOND_DIMS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tables = nn.ModuleList(nn.Embedding(card, emb_dim) for card in feature_dims)
        for t in self.tables:  # flax Embed's init: variance 1/emb_dim, truncated normal
            lecun_normal_(t.weight, generator)

    def forward(self, edge_attr: torch.Tensor) -> torch.Tensor:
        out = self.tables[0](edge_attr[:, 0])
        for i in range(1, len(self.tables)):
            out = out + self.tables[i](edge_attr[:, i])
        return out


class GINConv(nn.Module):
    """GIN with edge features: ``MLP((1 + eps) h + sum relu(h_u + e_uv))``,
    the MLP Dense, BatchNorm, relu, Dense (``gnn_model.py:619-650``); ``eps``
    a learned scalar from 0."""

    def __init__(self, emb_dim: int, bond_dims: Sequence[int] = BOND_DIMS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bond = BondEncoder(emb_dim, bond_dims, generator)
        self.eps = nn.Parameter(torch.zeros(()))
        self.lin1 = dense(emb_dim, emb_dim, True, generator)
        self.bn = BatchNorm(emb_dim)
        self.lin2 = dense(emb_dim, emb_dim, True, generator)

    def forward(self, h, src, dst, edge_attr, num_nodes: int, train: bool = False):
        msgs = torch.relu(h.index_select(0, src) + self.bond(edge_attr))
        x = (1 + self.eps) * h + segment_sum(msgs, dst, num_nodes)
        return self.lin2(torch.relu(self.bn(self.lin1(x), train)))


class MolGCNConv(nn.Module):
    """Degree-normalised conv with edge features (``gnn_model.py:653-689``):
    messages ``norm_u norm_v relu(h_u + e_uv)`` with ``norm = (deg + 1)^-1/2``,
    plus the self term ``relu(h + root_emb) / (deg + 1)``, ``h`` after a Dense."""

    def __init__(self, emb_dim: int, bond_dims: Sequence[int] = BOND_DIMS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bond = BondEncoder(emb_dim, bond_dims, generator)
        self.lin = dense(emb_dim, emb_dim, True, generator)
        self.root_emb = nn.Parameter(torch.randn(emb_dim, generator=generator))

    def forward(self, h, src, dst, edge_attr, num_nodes: int, train: bool = False):
        h = self.lin(h)
        deg = torch.bincount(dst, minlength=num_nodes).to(h.dtype) + 1.0
        norm = torch.rsqrt(deg)
        norm_uv = norm.index_select(0, src) * norm.index_select(0, dst)
        msgs = norm_uv[:, None] * torch.relu(h.index_select(0, src) + self.bond(edge_attr))
        return segment_sum(msgs, dst, num_nodes) + torch.relu(h + self.root_emb) / deg[:, None]


def graph_pool(h: torch.Tensor, graph_id: torch.Tensor, num_graphs: int,
               method: str = "mean") -> torch.Tensor:
    """sum, mean or max of each graph's node rows (``gnn_model.py:744-768``);
    an empty graph pools to 0."""
    if method == "sum":
        return segment_sum(h, graph_id, num_graphs)
    if method == "mean":
        count = torch.bincount(graph_id, minlength=num_graphs).to(h.dtype)
        return segment_sum(h, graph_id, num_graphs) / torch.clamp(count, min=1.0)[:, None]
    if method == "max":
        return segment_max(h, graph_id, num_graphs)
    raise ValueError(f"unknown pooling {method!r}")


class AttentionPool(nn.Module):
    """Gated attention pooling; the gate is Dense(2d), BatchNorm, relu,
    Dense(1) (``gnn_model.py:956-962``), softmaxed within each graph."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin1 = dense(dim, 2 * dim, True, generator)
        self.bn = BatchNorm(2 * dim)
        self.lin2 = dense(2 * dim, 1, True, generator)

    def forward(self, h, graph_id, num_graphs: int, train: bool = False):
        gate = self.lin2(torch.relu(self.bn(self.lin1(h), train)))  # (N, 1)
        return segment_sum(h * segment_softmax(gate, graph_id, num_graphs), graph_id,
                           num_graphs)


class Set2Set(nn.Module):
    """Set2Set pooling (``gnn_model.py:964-969``: dgl's Set2Set(emb_dim, 2,
    2)): ``n_iters`` rounds of a stacked LSTM query, attention within each
    graph, and the read-out; the output is (G, 2 emb_dim).

    Each ``nn.LSTMCell`` holds flax's ``LSTMCell``: flax's gates are
    ``i, f, g, o`` from an input Dense without bias (``ii``, ``if``, ``ig``,
    ``io``) plus a hidden Dense with bias (``hi`` ...); here their kernels
    are stacked in that order into ``weight_ih`` and ``weight_hh``, the
    biases into ``bias_hh``, and ``bias_ih`` stays 0.  Flax's carry is
    (c, h), torch's (h, c)."""

    def __init__(self, emb_dim: int, n_iters: int = 2, n_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb_dim, self.n_iters = emb_dim, n_iters
        self.cells = nn.ModuleList(nn.LSTMCell(2 * emb_dim if i == 0 else emb_dim, emb_dim)
                                   for i in range(n_layers))
        d = emb_dim
        with torch.no_grad():
            for cell in self.cells:  # flax: lecun-normal input, orthogonal hidden kernels
                for gate in range(4):
                    lecun_normal_(cell.weight_ih[gate * d:(gate + 1) * d], generator)
                    nn.init.orthogonal_(cell.weight_hh[gate * d:(gate + 1) * d],
                                        generator=generator)
                cell.bias_ih.zero_()
                cell.bias_hh.zero_()

    def forward(self, h, graph_id, num_graphs: int):
        d = self.emb_dim
        states = [(h.new_zeros((num_graphs, d)), h.new_zeros((num_graphs, d)))
                  for _ in self.cells]
        q_star = h.new_zeros((num_graphs, 2 * d))
        for _ in range(self.n_iters):
            x = q_star
            for i, cell in enumerate(self.cells):
                states[i] = cell(x, states[i])
                x = states[i][0]
            e = (h * x.index_select(0, graph_id)).sum(-1, keepdim=True)  # (N, 1)
            r = segment_sum(h * segment_softmax(e, graph_id, num_graphs), graph_id,
                            num_graphs)
            q_star = torch.cat([x, r], dim=-1)
        return q_star


class GNNNode(nn.Module):
    """The node-embedding stack (``gnn_model.py:692-860``): an atom Dense,
    ``num_layers`` convs each followed by BatchNorm, relu (not after the
    last), dropout and an optional residual; with ``virtual_node`` a
    per-graph latent added to every node's layer input, updated after each
    layer but the last from the sum-pool of that layer's input (with the
    latent added) by two Dense, BatchNorm, relu steps and dropout.  The
    residual adds that latent-augmented input."""

    def __init__(self, in_dim: int, emb_dim: int, num_layers: int = 5,
                 conv_type: str = "gin", virtual_node: bool = True, dropout: float = 0.5,
                 residual: bool = False, bond_dims: Sequence[int] = BOND_DIMS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_type not in ("gin", "gcn"):
            raise ValueError(f"unknown conv_type {conv_type!r}")
        self.num_layers, self.dropout, self.residual = num_layers, dropout, residual
        self.virtual_node = virtual_node
        self.atom_encoder = dense(in_dim, emb_dim, True, generator)
        conv = GINConv if conv_type == "gin" else MolGCNConv
        self.convs = nn.ModuleList(conv(emb_dim, bond_dims, generator)
                                   for _ in range(num_layers))
        self.bns = nn.ModuleList(BatchNorm(emb_dim) for _ in range(num_layers))
        if virtual_node:
            self.vn_init = nn.Parameter(torch.zeros(1, emb_dim))
            # two (Dense, BatchNorm) steps after each layer but the last
            self.vn_lins = nn.ModuleList(dense(emb_dim, emb_dim, True, generator)
                                         for _ in range(2 * (num_layers - 1)))
            self.vn_bns = nn.ModuleList(BatchNorm(emb_dim) for _ in range(2 * (num_layers - 1)))

    def forward(self, x, src, dst, edge_attr, graph_id, num_nodes: int, num_graphs: int,
                train: bool = False, generator: Optional[torch.Generator] = None):
        h = self.atom_encoder(x)
        vn = self.vn_init.expand(num_graphs, -1) if self.virtual_node else None
        for layer in range(self.num_layers):
            h_in = h if vn is None else h + vn.index_select(0, graph_id)
            h_out = self.bns[layer](self.convs[layer](h_in, src, dst, edge_attr, num_nodes,
                                                      train), train)
            if layer < self.num_layers - 1:
                h_out = torch.relu(h_out)
            h_out = dropout(h_out, self.dropout, train, generator)
            if self.residual:
                h_out = h_out + h_in
            if vn is not None and layer < self.num_layers - 1:
                v = vn + graph_pool(h_in, graph_id, num_graphs, "sum")
                for j in (2 * layer, 2 * layer + 1):
                    v = torch.relu(self.vn_bns[j](self.vn_lins[j](v), train))
                vn = dropout(v, self.dropout, train, generator)
            h = h_out
        return h


class MolGNN(nn.Module):
    """Graph-property prediction (``gnn_model.py:862-983`` ``GNN``): the node
    stack, a graph pooling (sum, mean, max, attention or set2set), and a
    Dense to ``num_tasks``.  ``in_dim`` is the atom features' width (the
    JAX module's Dense infers it)."""

    POOLINGS = ("sum", "mean", "max", "attention", "set2set")

    def __init__(self, num_tasks: int, in_dim: int, emb_dim: int = 300, num_layers: int = 5,
                 conv_type: str = "gin", virtual_node: bool = True, pooling: str = "mean",
                 dropout: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        if pooling not in self.POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}")
        self.pooling = pooling
        self.gnn_node = GNNNode(in_dim, emb_dim, num_layers, conv_type, virtual_node,
                                dropout, generator=generator)
        self.pool = (AttentionPool(emb_dim, generator) if pooling == "attention"
                     else Set2Set(emb_dim, generator=generator) if pooling == "set2set"
                     else None)
        self.graph_pred = dense(2 * emb_dim if pooling == "set2set" else emb_dim, num_tasks,
                                True, generator)

    def forward(self, x, src, dst, edge_attr, graph_id, num_nodes: int, num_graphs: int,
                train: bool = False, generator: Optional[torch.Generator] = None):
        h = self.gnn_node(x, src, dst, edge_attr, graph_id, num_nodes, num_graphs, train,
                          generator)
        if self.pooling == "attention":
            hg = self.pool(h, graph_id, num_graphs, train)
        elif self.pooling == "set2set":
            hg = self.pool(h, graph_id, num_graphs)
        else:
            hg = graph_pool(h, graph_id, num_graphs, self.pooling)
        return self.graph_pred(hg)

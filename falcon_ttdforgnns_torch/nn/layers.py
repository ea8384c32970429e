"""GNN layers: port of ``falcon_ttdforgnns_tpu/nn/layers.py`` (``SAGEConv``,
``GraphConv``, ``GATConv``, ``Bias``) and a BatchNorm with flax semantics.

Each ``nn.Linear`` holds a flax ``Dense`` kernel transposed: flax keeps
(in, out), ``nn.Linear.weight`` is (out, in)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.segment import headed_spmm, spmm_sum_chunked
from ..ops.spmm_blocked import BlockedSpmm, apply_blocked_spmm

# lecun_normal: variance 1/fan_in from a normal truncated at +-2 std, whose
# std before truncation is this much larger than after (flax's constant)
_TRUNC_STD = 0.87962566103423978
_CDF_LO, _CDF_HI = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax ``Dense``'s default kernel init on an (out, in) weight; the
    bits differ from jax.random, the distribution does not."""
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        u = torch.rand(w.shape, generator=generator, dtype=w.dtype, device=w.device)
        u = _CDF_LO + (_CDF_HI - _CDF_LO) * u
        w.copy_(torch.erfinv(2 * u - 1) * (math.sqrt(2.0) * std))
    return w


def dropout(h: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator (flax ``nn.Dropout``
    semantics: keep with prob 1-p, scale kept values by 1/(1-p))."""
    if not train or p == 0.0:
        return h
    keep = 1.0 - p
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


class SAGEConv(nn.Module):
    """GraphSAGE convolution, mean aggregator:
    ``h_v' = W_self h_v + W_neigh mean_{u in N(v)} h_u + b``.

    ``lin_self``/``lin_neigh`` hold the flax params ``self``/``neigh``
    transposed: flax's Dense kernel is (in, out), ``nn.Linear.weight`` is
    (out, in).

    ``dtype`` is flax ``Dense(dtype=...)``'s compute dtype: when set, the
    inputs, weights and bias are cast to it and the output has it; with
    ``None`` the inputs are promoted to the params' type (a bf16 input
    meets f32 params in f32).  The params stay f32 either way, and their
    gradients come back f32 through the casts."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias, device=device)
        self.lin_neigh = nn.Linear(in_dim, out_dim, bias=False, device=device)
        lecun_normal_(self.lin_self.weight, generator)
        lecun_normal_(self.lin_neigh.weight, generator)
        if use_bias:
            nn.init.zeros_(self.lin_self.bias)

    def _dense(self, lin: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        """flax Dense: the product, then the bias, each in the compute
        dtype."""
        dt = self.dtype or torch.promote_types(h.dtype, lin.weight.dtype)
        y = h.to(dt) @ lin.weight.to(dt).t()
        return y if lin.bias is None else y + lin.bias.to(dt)

    def forward(self, h_dst: torch.Tensor, h_neigh: torch.Tensor) -> torch.Tensor:
        return self._dense(self.lin_self, h_dst) + self._dense(self.lin_neigh, h_neigh)

    def neigh_product(self, h: torch.Tensor, width: int) -> torch.Tensor:
        """``lin_neigh`` of ``h`` (no bias), in the compute dtype, with zero
        columns after the output's to ``width``: the product that a mean
        taken after it (the mean is linear) gathers in place of ``h``."""
        w = self.lin_neigh.weight
        dt = self.dtype or torch.promote_types(h.dtype, w.dtype)
        w = torch.nn.functional.pad(w, (0, 0, 0, width - w.shape[0]))
        return h.to(dt) @ w.to(dt).t()

    def finish(self, h_dst: torch.Tensor, neigh: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` from the mean of :meth:`neigh_product` (its columns
        past the output's dropped) in place of ``lin_neigh`` of the mean: the
        self product and bias, then the add."""
        return self._dense(self.lin_self, h_dst) + neigh[:, :self.lin_self.out_features]


def dense(in_dim: int, out_dim: int, use_bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """flax ``Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(in_dim, out_dim, bias=use_bias)
    lecun_normal_(lin.weight, generator)
    if use_bias:
        nn.init.zeros_(lin.bias)
    return lin


class GraphConv(nn.Module):
    """GCN convolution with symmetric degree normalisation,
    ``H' = D^{-1/2} A D^{-1/2} H W + b`` (the dense layer first, as the
    reference).  The aggregation runs over the COO edges with
    ``index_add_`` (``--spmm xla``), or through the window-blocked kernel
    when a :class:`BlockedSpmm` is passed (``--spmm blocked``).  ``lin`` is
    the flax ``Dense_0``."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = dense(in_dim, out_dim, use_bias, generator)

    def forward(self, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                in_deg: torch.Tensor, num_nodes: int,
                blocked: Optional[BlockedSpmm] = None) -> torch.Tensor:
        h = self.lin(h)
        norm = torch.rsqrt(torch.clamp(in_deg.to(h.dtype), min=1.0))[:, None]
        hn = h * norm
        if blocked is not None:
            agg = apply_blocked_spmm(hn, blocked)
        else:
            agg = spmm_sum_chunked(hn, src, dst, num_nodes)
        return agg * norm


def glorot_uniform_(p: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``glorot_uniform`` with the fans given: U(-a, a), a =
    sqrt(6 / (fan_in + fan_out)).  For an attention vector of shape
    (1, H, Do) flax takes fan_in = H and fan_out = Do, which
    ``nn.init.xavier_uniform_`` does not."""
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        u = torch.rand(p.shape, generator=generator, dtype=p.dtype, device=p.device)
        p.copy_((2 * u - 1) * a)
    return p


class GATConv(nn.Module):
    """Multi-head graph attention (the reference's ``GATConv``):
    ``e = leaky_relu(el[src] + er[dst])``, an edge softmax over each dst's
    in-edges (an empty segment's max is taken as 0, the sum floored at
    1e-9), optional attention dropout, the per-head weighted aggregation
    :func:`headed_spmm`, and a residual dense branch.  With
    ``use_symmetric_norm`` the source features are scaled by deg^-1/2
    before ``el`` and the aggregation, and the output by deg^1/2.

    The softmax's max is detached: the softmax does not depend on it, so
    its gradient through the max is zero (the reference's autodiff sums to
    zero up to rounding)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 negative_slope: float = 0.2, residual: bool = True,
                 use_symmetric_norm: bool = False, attn_dropout: float = 0.0,
                 edge_chunk: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, Do = num_heads, out_dim
        self.num_heads, self.out_dim = H, Do
        self.negative_slope = negative_slope
        self.use_symmetric_norm = use_symmetric_norm
        self.attn_dropout = attn_dropout
        # the reference's auto chunk: a (chunk, H, Do) f32 slab of ~512 MB
        self.edge_chunk = edge_chunk or max(1 << 14, min(1 << 22, (512 << 20) // (4 * H * Do)))
        self.fc = dense(in_dim, H * Do, False, generator)
        self.attn_l = nn.Parameter(glorot_uniform_(torch.empty(1, H, Do), H, Do, generator))
        self.attn_r = nn.Parameter(glorot_uniform_(torch.empty(1, H, Do), H, Do, generator))
        self.res_fc = dense(in_dim, H * Do, False, generator) if residual else None

    def forward(self, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                in_deg: torch.Tensor, num_nodes: int, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H, Do = self.num_heads, self.out_dim
        feat = self.fc(h).reshape(-1, H, Do)
        feat_src = feat
        if self.use_symmetric_norm:
            deg = torch.clamp(in_deg.to(h.dtype), min=1.0)
            feat_src = feat * torch.pow(deg, -0.5)[:, None, None]
        el = (feat_src * self.attn_l).sum(-1)  # (N, H)
        er = (feat * self.attn_r).sum(-1)
        e = torch.nn.functional.leaky_relu(el.index_select(0, src) + er.index_select(0, dst),
                                           self.negative_slope)
        idx = dst[:, None].expand(-1, H)
        emax = torch.full((num_nodes, H), float("-inf"), dtype=e.dtype, device=e.device)
        emax = emax.scatter_reduce(0, idx, e.detach(), reduce="amax")
        emax = torch.where(torch.isfinite(emax), emax, torch.zeros_like(emax))
        ex = torch.exp(e - emax.index_select(0, dst))
        esum = torch.zeros((num_nodes, H), dtype=e.dtype, device=e.device).index_add(0, dst, ex)
        alpha = ex / torch.clamp(esum.index_select(0, dst), min=1e-9)
        alpha = dropout(alpha, self.attn_dropout, train, generator)
        out = headed_spmm(feat_src, alpha, src, dst, num_nodes, self.edge_chunk)
        if self.use_symmetric_norm:
            out = out * torch.pow(deg, 0.5)[:, None, None]
        if self.res_fc is not None:
            out = out + self.res_fc(h).reshape(-1, H, Do)
        return out.reshape(-1, H * Do)


class Bias(nn.Module):
    """A learned bias alone (the last layer of the reference GAT)."""

    def __init__(self, dim: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the rows of (N, F), not
    ``torch.nn.BatchNorm1d``: in training the batch statistics are
    ``mean(x)`` and the biased ``max(0, mean(x^2) - mean(x)^2)``, used both to
    normalise and, with ``momentum`` 0.99 on the old value, to update the
    running statistics (torch's momentum means the other weight, and its
    running variance is the unbiased one); in eval the running statistics
    normalise.  ``weight``/``bias`` are flax's ``scale``/``bias``."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

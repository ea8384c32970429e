"""SpMM over a COO edge list for full-graph propagation.

Port of ``falcon_ttdforgnns_tpu/ops/segment.py``.  In the JAX package these
are XLA gathers and scatter-adds, not Pallas kernels; their port is
``index_select`` and ``index_add_``, over edge chunks where the reference
chunks, which bounds the (chunk, D) gathered messages.
"""

from __future__ import annotations

from typing import Optional

import torch

SPMM_CHUNK = 1 << 22         # spmm_sum_chunked, spmm_mean, gcn_norm_spmm
HEADED_SPMM_CHUNK = 1 << 19  # headed_spmm


def spmm_sum(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, num_nodes: int,
             edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = sum_{(u->v)} w_e * h[u], one shot (small graphs)."""
    msgs = h.index_select(0, src)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    out = torch.zeros((num_nodes, h.shape[1]), dtype=msgs.dtype, device=h.device)
    return out.index_add_(0, dst, msgs)


def _scatter_chunked(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     num_nodes: int, edge_weight: Optional[torch.Tensor],
                     chunk: int) -> torch.Tensor:
    out = torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype, device=h.device)
    for s in range(0, src.shape[0], chunk):
        msgs = h.index_select(0, src[s:s + chunk])
        if edge_weight is not None:
            msgs = msgs * edge_weight[s:s + chunk, None]
        out.index_add_(0, dst[s:s + chunk], msgs)
    return out


class ChunkedSpmm(torch.autograd.Function):
    """The chunked sum with the transposed sum as its backward (d_h = A^T g,
    chunk by chunk), so that no chunk's (chunk, D) messages are kept for
    the backward: autograd of ``index_add_`` would keep every chunk's,
    ~4 GB each at products' 2^22-edge chunks of 256 f32 values."""

    @staticmethod
    def forward(ctx, h, src, dst, num_nodes: int, edge_weight, chunk: int):
        ctx.save_for_backward(src, dst, edge_weight)
        ctx.n_rows, ctx.chunk = h.shape[0], chunk
        return _scatter_chunked(h, src, dst, num_nodes, edge_weight, chunk)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        src, dst, edge_weight = ctx.saved_tensors
        return (_scatter_chunked(g.contiguous(), dst, src, ctx.n_rows, edge_weight, ctx.chunk),
                None, None, None, None, None)


def spmm_sum_chunked(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     num_nodes: int, edge_weight: Optional[torch.Tensor] = None,
                     chunk: int = SPMM_CHUNK) -> torch.Tensor:
    """out[v] = sum_{(u->v)} w_e * h[u], scattered chunk by chunk; the
    gradient reaches ``h`` (not the fixed ``edge_weight``)."""
    if edge_weight is not None and edge_weight.requires_grad:
        raise ValueError("spmm_sum_chunked takes fixed edge weights (no gradient)")
    return ChunkedSpmm.apply(h, src, dst, num_nodes, edge_weight, chunk)


def spmm_mean(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              num_nodes: int, in_deg: Optional[torch.Tensor] = None,
              chunk: int = SPMM_CHUNK) -> torch.Tensor:
    """Mean aggregation: sum / in-degree (degree from dst if not given)."""
    s = spmm_sum_chunked(h, src, dst, num_nodes, chunk=chunk)
    if in_deg is None:
        in_deg = torch.bincount(dst, minlength=num_nodes)
    return s / torch.clamp(in_deg.to(h.dtype), min=1.0)[:, None]


def gcn_norm_spmm(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  num_nodes: int, in_deg: torch.Tensor,
                  chunk: int = SPMM_CHUNK) -> torch.Tensor:
    """Symmetric-normalised SpMM: D^{-1/2} A D^{-1/2} h."""
    norm = torch.rsqrt(torch.clamp(in_deg.to(h.dtype), min=1.0))[:, None]
    return spmm_sum_chunked(h * norm, src, dst, num_nodes, chunk=chunk) * norm


def _headed_scatter(feat: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, num_out: int, chunk: int) -> torch.Tensor:
    """out[dst_e] += w[e, :, None] * feat[src_e]: feat (N, H, D), w (E, H)
    -> (num_out, H, D), edge chunk by edge chunk."""
    out = torch.zeros((num_out,) + tuple(feat.shape[1:]), dtype=feat.dtype,
                      device=feat.device)
    for s in range(0, src.shape[0], chunk):
        msgs = feat.index_select(0, src[s:s + chunk]) * w[s:s + chunk, :, None]
        out.index_add_(0, dst[s:s + chunk], msgs)
    return out


def _headed_edge_dot(feat: torch.Tensor, g: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, chunk: int) -> torch.Tensor:
    """dw[e, h] = <feat[src_e, h, :], g[dst_e, h, :]>, edge chunk by chunk."""
    return torch.cat([(feat.index_select(0, src[s:s + chunk])
                       * g.index_select(0, dst[s:s + chunk])).sum(-1)
                      for s in range(0, src.shape[0], chunk)]
                     or [feat.new_zeros((0, feat.shape[1]))])


class HeadedSpmm(torch.autograd.Function):
    """out[v, h] = sum_{e: dst_e = v} w[e, h] * feat[src_e, h] without the
    (E, H, D) messages: the forward scatters chunk by chunk; the backward
    is the same scatter with src and dst swapped for d_feat, and a chunked
    per-edge row dot for d_w (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, feat, w, src, dst, num_nodes: int, chunk: int):
        ctx.save_for_backward(feat, w, src, dst)
        ctx.chunk = chunk
        return _headed_scatter(feat, w, src, dst, num_nodes, chunk)

    @staticmethod
    def backward(ctx, g):
        feat, w, src, dst = ctx.saved_tensors
        g = g.contiguous()
        d_feat = d_w = None
        if ctx.needs_input_grad[0]:
            d_feat = _headed_scatter(g, w, dst, src, feat.shape[0], ctx.chunk)
        if ctx.needs_input_grad[1]:
            d_w = _headed_edge_dot(feat, g, src, dst, ctx.chunk)
        return d_feat, d_w, None, None, None, None


def headed_spmm(feat: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, num_nodes: int,
                chunk: int = HEADED_SPMM_CHUNK) -> torch.Tensor:
    """Per-head weighted aggregation of GAT: feat (N, H, D), w (E, H)."""
    return HeadedSpmm.apply(feat, w, src, dst, num_nodes, chunk)

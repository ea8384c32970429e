"""SpMM over a COO edge list for full-graph propagation.

Port of ``falcon_ttdforgnns_tpu/ops/segment.py``.  In the JAX package these
are XLA gathers and scatter-adds, not Pallas kernels; their port is
``index_select`` and ``index_add_``, over edge chunks where the reference
chunks, which bounds the (chunk, D) gathered messages.

Under bf16, XLA's segment sum adds each destination row's messages in
edge order with a bf16 rounding after every add, where ``index_add_``
sums in f32 and rounds once; so :func:`spmm_mean` of a bf16 ``h`` (the
``--bf16`` evaluate and layer-wise inference) goes through
:func:`segment_mean_bf16`, the wrapper of the Hopper kernel
``segment_mean_bf16`` (``csrc/tower_kernels.cu``), which adds in that
order and rounds as XLA does, beside its plain version
:func:`segment_mean_bf16_plain`.  This is no TPU kernel's port.  The
wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.  Every launch adds one to its
entry in :func:`launch_counts`.

An f32 ``h`` that needs no gradient (layer 1 of the ``--bf16`` evaluate,
whose lookup rows are f32, and every layer of an f32 one) goes through
:func:`csr_mean_f32`, the wrapper of ``csr_mean_f32`` (the same source),
which sums each row's in-edges in edge order where they lie instead of
materialising the chunked scatter's (chunk, D) messages; its plain version
:func:`csr_mean_f32_plain` is that scatter in edge order.  Both forward-only
means read the row index :func:`edges_by_row`, which a full-graph forward
builds once and hands to every layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.metrics import count, span
from . import _build

SPMM_CHUNK = 1 << 22         # spmm_sum_chunked, spmm_mean, gcn_norm_spmm
HEADED_SPMM_CHUNK = 1 << 19  # headed_spmm
# a bf16 count of ones stops here: 256 + 1 rounds (to even) back to 256
BF16_COUNT_MAX = 256

KERNELS = ("segment_mean_bf16", "csr_mean_f32")
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


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


def edges_by_row(src: torch.Tensor, dst: torch.Tensor,
                 num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The COO edges as CSR rows of their destinations: (src in row order,
    indptr (num_nodes + 1,) int64, whose ``diff()`` is each row's
    in-degree).  Each row keeps its edges in their COO order:
    ``CSRGraph.to_coo()`` edges, whose dst is non-decreasing, are taken as
    they are, others by a stable sort.  The order check reads one value
    into the host (``spmm.host_reads``); the whole build is the span
    ``spmm.rows``."""
    with span("spmm.rows"):
        if dst.numel() > 1:
            count("spmm.host_reads")
            if bool((dst[1:] < dst[:-1]).any()):
                dst, order = torch.sort(dst, stable=True)
                src = src.index_select(0, order)
        counts = torch.bincount(dst, minlength=num_nodes)
        indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        return src.long().contiguous(), indptr


def segment_mean_bf16_plain(h: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                            deg: torch.Tensor) -> torch.Tensor:
    """(N, D) bf16 mean of each row's in-edges: ``acc = bf16(acc +
    h[src[e]])`` over the row's edges ``indptr[v] .. indptr[v+1] - 1`` in
    order from +0, then ``bf16(acc / max(bf16(deg[v]), 1))``.  The k-th
    in-edge of every row at once, k = 0, 1, ...: each add rounds to bf16 as
    XLA's does."""
    n = indptr.shape[0] - 1
    counts = indptr[1:] - indptr[:-1]
    rows = torch.repeat_interleave(torch.arange(n, device=h.device), counts)
    rank = torch.arange(src.shape[0], device=h.device) - indptr[rows]
    by_rank = torch.argsort(rank, stable=True)
    ends = torch.cumsum(torch.bincount(rank, minlength=1), 0).tolist()
    acc = torch.zeros((n, h.shape[1]), dtype=torch.bfloat16, device=h.device)
    start = 0
    for end in ends:
        sel = by_rank[start:end]
        r = rows.index_select(0, sel)
        acc[r] = acc[r] + h.index_select(0, src.index_select(0, sel))
        start = end
    den = torch.clamp(deg.to(torch.bfloat16), min=1.0)
    return (acc.float() / den.float()[:, None]).to(torch.bfloat16)


def segment_mean_bf16(h: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                      deg: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: h (n_h, D) bf16, src (E,) int64 in row order,
    indptr (N + 1,) int64, deg (N,) -> (N, D) bf16 (see
    :func:`segment_mean_bf16_plain`).  Forward only."""
    if h.dtype != torch.bfloat16:
        raise TypeError(f"segment_mean_bf16 takes bfloat16, not {h.dtype}")
    if {t.device.type for t in (h, src, indptr, deg)} == {"cpu"}:
        return segment_mean_bf16_plain(h, src, indptr, deg)
    if len({t.device for t in (h, src, indptr, deg)}) != 1 or h.device.type != "cuda":
        raise ValueError(f"segment_mean_bf16 takes tensors on one CUDA device or on the "
                         f"CPU, got {h.device}, {src.device}, {indptr.device}, {deg.device}")
    n = indptr.shape[0] - 1
    if src.dtype != torch.int64 or indptr.dtype != torch.int64 or src.dim() != 1 or n < 0:
        raise TypeError("segment_mean_bf16: src and indptr are 1-D int64")
    if deg.shape != (n,):
        raise ValueError(f"segment_mean_bf16: deg of shape {tuple(deg.shape)}, expected ({n},)")
    count("spmm.host_reads", 4 if src.numel() else 2)  # the int() reads below
    if int(indptr[0]) != 0 or int(indptr[-1]) != src.shape[0] or (src.numel() and (
            int(src.min()) < 0 or int(src.max()) >= h.shape[0])):
        raise ValueError("segment_mean_bf16: indptr must span src, and src index rows of h")
    h, src, indptr = h.contiguous(), src.contiguous(), indptr.contiguous()
    deg = deg.to(torch.float32).contiguous()
    out = torch.empty((n, h.shape[1]), dtype=torch.bfloat16, device=h.device)
    rc = _build.library("tower_kernels").segment_mean_bf16(
        h.data_ptr(), src.data_ptr(), indptr.data_ptr(), deg.data_ptr(), n, h.shape[1],
        out.data_ptr(), _build.current_stream(h.get_device()))
    _build.check(rc, "segment_mean_bf16", "tower_kernels")
    if n:
        _launches["segment_mean_bf16"] += 1
    return out


def csr_mean_f32_plain(h: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                       deg: torch.Tensor) -> torch.Tensor:
    """(N, D) f32 mean of each row's in-edges: ``acc = acc + h[src[e]]``
    over the row's edges ``indptr[v] .. indptr[v+1] - 1`` in order from +0,
    then ``acc / max(deg[v], 1)``.  An ``index_add_`` of the edges in row
    order, chunk by chunk, which on the CPU adds its indices in turn, so
    each row's sum runs in edge order; on the card its atomic adds keep no
    order, so the kernel is held to this version on the CPU."""
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=h.device), indptr.diff(),
                                   output_size=src.shape[0])
    acc = _scatter_chunked(h, src, rows, n, None, SPMM_CHUNK)
    return acc / torch.clamp(deg.to(torch.float32), min=1.0)[:, None]


def csr_mean_f32(h: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                 deg: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: h (n_h, D) f32, src (E,) int64 in row order,
    indptr (N + 1,) int64, deg (N,) -> (N, D) f32 (see
    :func:`csr_mean_f32_plain`).  Forward only.  Its bound checks read
    one set of values into the host (``spmm.host_reads``)."""
    if h.dtype != torch.float32:
        raise TypeError(f"csr_mean_f32 takes float32, not {h.dtype}")
    if h.requires_grad and torch.is_grad_enabled():
        raise ValueError("csr_mean_f32 is forward only")
    if {t.device.type for t in (h, src, indptr, deg)} == {"cpu"}:
        return csr_mean_f32_plain(h, src, indptr, deg)
    if len({t.device for t in (h, src, indptr, deg)}) != 1 or h.device.type != "cuda":
        raise ValueError(f"csr_mean_f32 takes tensors on one CUDA device or on the CPU, "
                         f"got {h.device}, {src.device}, {indptr.device}, {deg.device}")
    n = indptr.shape[0] - 1
    if src.dtype != torch.int64 or indptr.dtype != torch.int64 or src.dim() != 1 or n < 0:
        raise TypeError("csr_mean_f32: src and indptr are 1-D int64")
    if deg.shape != (n,):
        raise ValueError(f"csr_mean_f32: deg of shape {tuple(deg.shape)}, expected ({n},)")
    count("spmm.host_reads")
    first, last, *lim = torch.stack([indptr[0], indptr[-1],
                                     *(torch.aminmax(src) if src.numel() else ())]).tolist()
    if first != 0 or last != src.shape[0] or (lim and (lim[0] < 0 or lim[1] >= h.shape[0])):
        raise ValueError("csr_mean_f32: indptr must span src, and src index rows of h")
    h, src, indptr = h.contiguous(), src.contiguous(), indptr.contiguous()
    deg = deg.to(torch.float32).contiguous()
    out = torch.empty((n, h.shape[1]), dtype=torch.float32, device=h.device)
    rc = _build.library("tower_kernels").csr_mean_f32(
        h.data_ptr(), src.data_ptr(), indptr.data_ptr(), deg.data_ptr(), n, h.shape[1],
        out.data_ptr(), _build.current_stream(h.get_device()))
    _build.check(rc, "csr_mean_f32", "tower_kernels")
    if n:
        _launches["csr_mean_f32"] += 1
    return out


def spmm_mean(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              num_nodes: int, in_deg: Optional[torch.Tensor] = None,
              chunk: int = SPMM_CHUNK,
              rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Mean aggregation: sum / in-degree (degree from dst if not given).

    Where a bf16 or f32 ``h`` needs no gradient the mean walks the row
    index ``rows``, :func:`edges_by_row` of the same edges (built here
    where none is given), whatever ``chunk``:

    - a bf16 ``h`` gives the JAX package's bf16 result bit for bit: each
      row's sum in edge order with a bf16 rounding after every add
      (:func:`segment_mean_bf16`; the reference's chunks keep that order),
      divided by the degree cast to bf16, counted as a bf16 sum of ones
      (so at most 256) where none is given;
    - an f32 ``h`` sums each row in edge order in f32
      (:func:`csr_mean_f32`) and divides by the degree, the full count
      where none is given.

    An f32 ``h`` that needs its gradient takes the chunked scatter, with
    the transposed sum as its backward; a bf16 one raises (train
    full-graph in f32)."""
    if h.dtype == torch.bfloat16 and h.requires_grad and torch.is_grad_enabled():
        raise ValueError("the bf16 spmm_mean is forward only; train full-graph in f32")
    if h.dtype in (torch.bfloat16, torch.float32) and not (
            h.requires_grad and torch.is_grad_enabled()):
        src, indptr = edges_by_row(src, dst, num_nodes) if rows is None else rows
        if in_deg is None:
            in_deg = indptr.diff()
            if h.dtype == torch.bfloat16:
                in_deg = torch.clamp(in_deg, max=BF16_COUNT_MAX)
        if h.dtype == torch.float32:
            return csr_mean_f32(h, src, indptr, in_deg)
        return segment_mean_bf16(h, src, indptr, in_deg)
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

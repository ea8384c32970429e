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
means read the row index :class:`RowIndex`, which :func:`edges_by_row`
builds and checks; :class:`FullGraph` holds a graph's edges with their
index, built once for its life, and decides which layout serves a mean.
The CSR wrappers share one check on host integers, :func:`csr_check`.

A mean taken after a narrowing product instead of before it
(:meth:`FullGraph.projected_mean`: the last SAGE conv of an evaluate, whose
mean then gathers 48-wide rows where it gathered 256-wide ones) sums each
row in f32 and rounds once: rows of mixed signs lose too much to a bf16
rounding after every add.  A bf16 product goes through
:func:`csr_mean_bf16`, the wrapper of ``csr_mean_bf16`` (the same source),
beside its plain version :func:`csr_mean_bf16_plain`; an f32 one through
:func:`csr_mean_f32`.  Their rows are padded to whole 16-byte loads,
:data:`VECTOR` values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..utils.metrics import count, span
from . import _build

SPMM_CHUNK = 1 << 22         # spmm_sum_chunked, spmm_mean, gcn_norm_spmm
HEADED_SPMM_CHUNK = 1 << 19  # headed_spmm
# a bf16 count of ones stops here: 256 + 1 rounds (to even) back to 256
BF16_COUNT_MAX = 256

# values of one 16-byte load: the width of a CSR kernel's rows is a multiple of it
VECTOR = {torch.bfloat16: 8, torch.float32: 4}

KERNELS = ("segment_mean_bf16", "csr_mean_f32", "csr_mean_bf16")
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


@dataclass(frozen=True)
class RowIndex:
    """The COO edges as CSR rows of their destinations, as
    :func:`edges_by_row` makes and checks it: ``src`` (E,) int64, the
    sources in row order, each row's edges in their COO order; ``indptr``
    (N + 1,) int64, which spans ``src`` and whose ``diff()`` is each row's
    in-degree; ``num_src``, the count of rows that ``src`` may index."""

    src: torch.Tensor
    indptr: torch.Tensor
    num_src: int

    @property
    def num_rows(self) -> int:
        return self.indptr.shape[0] - 1


def edges_by_row(src: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 num_src: Optional[int] = None) -> RowIndex:
    """The row index of the COO edges ``src -> dst`` over ``num_nodes``
    destination rows, whose sources index ``num_src`` rows (``num_nodes``
    where None).  ``CSRGraph.to_coo()`` edges, whose dst is non-decreasing,
    are taken as they are, others by a stable sort.  Refuses, before it
    builds anything, a dst outside ``[0, num_nodes)``, a src outside
    ``[0, num_src)`` and a src and dst of different lengths (whose
    ``indptr`` could not span ``src``): the order and both bounds come to
    the host in one read (``spmm.host_reads``).  The whole build is the span
    ``spmm.rows``."""
    num_src = num_nodes if num_src is None else num_src
    with span("spmm.rows"):
        if src.dim() != 1 or src.shape != dst.shape:
            raise ValueError(f"edges_by_row: src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} are not one edge list: indptr would "
                             f"not span src")
        if dst.numel():
            count("spmm.host_reads")
            lo_d, hi_d, lo_s, hi_s, unsorted = torch.stack([t.long() for t in (
                *torch.aminmax(dst), *torch.aminmax(src), (dst[1:] < dst[:-1]).any())]).tolist()
            for name, lo, hi, rows in (("dst", lo_d, hi_d, num_nodes),
                                       ("src", lo_s, hi_s, num_src)):
                if lo < 0 or hi >= rows:
                    raise ValueError(f"edges_by_row: {name} spans {lo}..{hi}, outside "
                                     f"its {rows} rows")
            if unsorted:
                dst, order = torch.sort(dst, stable=True)
                src = src.index_select(0, order)
        nodes = torch.arange(num_nodes + 1, dtype=dst.dtype, device=dst.device)
        indptr = torch.searchsorted(dst.contiguous(), nodes)
        return RowIndex(src.long().contiguous(), indptr, num_src)


def csr_check(name: str, index: RowIndex, h: torch.Tensor, dtypes: Tuple[torch.dtype, ...],
              rowwise: Tuple[torch.Tensor, ...] = (), others: Tuple[torch.Tensor, ...] = ()
              ) -> bool:
    """The one check of the CSR wrappers (:func:`segment_mean_bf16`,
    :func:`csr_mean_f32`, :func:`csr_mean_bf16`, ``attention.csr_gat``), on
    host integers alone:
    ``h``'s dtype among ``dtypes``; forward only; one row of each ``rowwise``
    tensor (a mean's ``deg``, the attention's ``er``) an index row; the
    index's sources inside ``h``'s rows; and the device rule.  False where
    every tensor is on the CPU (the wrapper runs its plain version), True
    where all are on one CUDA device (it launches its kernel); else it
    raises."""
    if h.dtype not in dtypes:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))}, not {h.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, *others)):
        raise ValueError(f"{name} is forward only")
    for t in rowwise:
        if t.dim() == 0 or t.shape[0] != index.num_rows:
            raise ValueError(f"{name}: a tensor of shape {tuple(t.shape)} for an index "
                             f"of {index.num_rows} rows")
    if index.num_src > h.shape[0]:
        raise ValueError(f"{name}: the index's sources reach row {index.num_src - 1}, "
                         f"past the {h.shape[0]} rows of its input")
    devices = {t.device for t in (h, index.src, index.indptr, *rowwise, *others)}
    if {d.type for d in devices} == {"cpu"}:
        return False
    if len(devices) != 1 or h.device.type != "cuda":
        raise ValueError(f"{name} takes tensors on one CUDA device or on the CPU, got "
                         f"{', '.join(sorted(map(str, devices)))}")
    return True


def _sum_by_rank(h: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(N, D) ``dtype`` sum of each row's in-edges: ``acc = acc +
    h[src[e]]`` in ``dtype`` over the row's edges ``indptr[v] ..
    indptr[v+1] - 1`` in order from +0.  The k-th in-edge of every row at
    once, k = 0, 1, ...: each add rounds to ``dtype``, in edge order on any
    device."""
    n = indptr.shape[0] - 1
    counts = indptr[1:] - indptr[:-1]
    rows = torch.repeat_interleave(torch.arange(n, device=h.device), counts)
    rank = torch.arange(src.shape[0], device=h.device) - indptr[rows]
    by_rank = torch.argsort(rank, stable=True)
    ends = torch.cumsum(torch.bincount(rank, minlength=1), 0).tolist()
    acc = torch.zeros((n, h.shape[1]), dtype=dtype, device=h.device)
    start = 0
    for end in ends:
        sel = by_rank[start:end]
        r = rows.index_select(0, sel)
        acc[r] = acc[r] + h.index_select(0, src.index_select(0, sel)).to(dtype)
        start = end
    return acc


def segment_mean_bf16_plain(h: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                            deg: torch.Tensor) -> torch.Tensor:
    """(N, D) bf16 mean of each row's in-edges: ``acc = bf16(acc +
    h[src[e]])`` over the row's edges ``indptr[v] .. indptr[v+1] - 1`` in
    order from +0, then ``bf16(acc / max(bf16(deg[v]), 1))``: each add
    rounds to bf16 as XLA's does."""
    acc = _sum_by_rank(h, src, indptr, torch.bfloat16)
    den = torch.clamp(deg.to(torch.bfloat16), min=1.0)
    return (acc.float() / den.float()[:, None]).to(torch.bfloat16)


def segment_mean_bf16(h: torch.Tensor, index: RowIndex, deg: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: h (n_h, D) bf16, the row index of N rows, deg
    (N,) -> (N, D) bf16 (see :func:`segment_mean_bf16_plain`).  Forward
    only."""
    if not csr_check("segment_mean_bf16", index, h, (torch.bfloat16,), (deg,)):
        return segment_mean_bf16_plain(h, index.src, index.indptr, deg)
    return _launch_mean("segment_mean_bf16", h, index, deg)


def _launch_mean(name: str, h: torch.Tensor, index: RowIndex, deg: torch.Tensor) -> torch.Tensor:
    """One launch of the mean kernel ``name`` on checked arguments."""
    n, h = index.num_rows, h.contiguous()
    deg = deg.to(torch.float32).contiguous()
    out = torch.empty((n, h.shape[1]), dtype=h.dtype, device=h.device)
    rc = getattr(_build.library("tower_kernels"), name)(
        h.data_ptr(), index.src.data_ptr(), index.indptr.data_ptr(), deg.data_ptr(), n,
        h.shape[1], out.data_ptr(), _build.current_stream(h.get_device()))
    _build.check(rc, name, "tower_kernels")
    if n:
        _launches[name] += 1
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


def csr_mean_f32(h: torch.Tensor, index: RowIndex, deg: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: h (n_h, D) f32, the row index of N rows, deg
    (N,) -> (N, D) f32 (see :func:`csr_mean_f32_plain`).  Forward only."""
    if not csr_check("csr_mean_f32", index, h, (torch.float32,), (deg,)):
        return csr_mean_f32_plain(h, index.src, index.indptr, deg)
    return _launch_mean("csr_mean_f32", h, index, deg)


def csr_mean_bf16_plain(p: torch.Tensor, src: torch.Tensor, indptr: torch.Tensor,
                        deg: torch.Tensor) -> torch.Tensor:
    """(N, D) bf16 mean of each row's in-edges summed in f32: ``acc = acc
    + f32(p[src[e]])`` over the row's edges in order from +0, then
    ``bf16(acc / max(deg[v], 1))``, the one rounding to bf16.  Its sums keep
    edge order on any device, so on the card too the kernel is held to it
    bit for bit; on the CPU it is ``csr_mean_f32_plain(p.float(),
    ...).to(bfloat16)``."""
    acc = _sum_by_rank(p, src, indptr, torch.float32)
    return (acc / torch.clamp(deg.to(torch.float32), min=1.0)[:, None]).to(torch.bfloat16)


def csr_mean_bf16(p: torch.Tensor, index: RowIndex, deg: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: p (n_p, D) bf16 with D a multiple of 8 (whole
    16-byte loads; on the card its data 16-byte aligned, else the launch
    raises), the row index of N rows, deg (N,) -> (N, D) bf16 (see
    :func:`csr_mean_bf16_plain`).  Forward only."""
    if p.dim() != 2 or p.shape[1] % VECTOR[torch.bfloat16]:
        raise ValueError(f"csr_mean_bf16: rows of shape {tuple(p.shape[1:])}, not a multiple "
                         f"of {VECTOR[torch.bfloat16]} values (16 bytes; pad the product)")
    if not csr_check("csr_mean_bf16", index, p, (torch.bfloat16,), (deg,)):
        return csr_mean_bf16_plain(p, index.src, index.indptr, deg)
    return _launch_mean("csr_mean_bf16", p, index, deg)


@dataclass
class FullGraph:
    """The full graph's edges as a trainer keeps them for its life: the COO
    ``src`` and ``dst`` (int64, on the device), the in-degrees ``deg`` (None:
    counted from the edges), ``num_nodes``, the edge ``chunk`` of the
    gradient path, and the row index, built by :meth:`index` the first time
    it is asked for and kept."""

    src: torch.Tensor
    dst: torch.Tensor
    num_nodes: int
    deg: Optional[torch.Tensor] = None
    chunk: int = SPMM_CHUNK
    _index: Optional[RowIndex] = field(default=None, repr=False)

    def index(self) -> RowIndex:
        if self._index is None:
            self._index = edges_by_row(self.src, self.dst, self.num_nodes)
        return self._index

    def mean(self, h: torch.Tensor) -> torch.Tensor:
        """Mean aggregation of ``h`` over every in-edge: sum / in-degree.

        Where a bf16 or f32 ``h`` needs no gradient the mean walks the row
        index, whatever ``chunk``:

        - a bf16 ``h`` gives the JAX package's bf16 result bit for bit: each
          row's sum in edge order with a bf16 rounding after every add
          (:func:`segment_mean_bf16`; the reference's chunks keep that
          order), divided by the degree cast to bf16, counted as a bf16 sum
          of ones (so at most 256) where none is given;
        - an f32 ``h`` sums each row in edge order in f32
          (:func:`csr_mean_f32`) and divides by the degree, the full count
          where none is given.

        An f32 ``h`` that needs its gradient takes the chunked scatter, with
        the transposed sum as its backward; a bf16 one raises (train
        full-graph in f32)."""
        grad = h.requires_grad and torch.is_grad_enabled()
        if h.dtype == torch.bfloat16 and grad:
            raise ValueError("the bf16 spmm_mean is forward only; train full-graph in f32")
        if h.dtype in (torch.bfloat16, torch.float32) and not grad:
            index, deg = self.index(), self._row_degree(h.dtype)
            if h.dtype == torch.float32:
                return csr_mean_f32(h, index, deg)
            return segment_mean_bf16(h, index, deg)
        s = spmm_sum_chunked(h, self.src, self.dst, self.num_nodes, chunk=self.chunk)
        deg = self.deg
        if deg is None:
            deg = torch.bincount(self.dst, minlength=self.num_nodes)
        return s / torch.clamp(deg.to(h.dtype), min=1.0)[:, None]

    def projected_mean(self, p: torch.Tensor, of: torch.dtype) -> torch.Tensor:
        """The mean of ``p``, a linear map of an ``of`` input taken before
        its mean, forward only: each row's sum in edge order in f32, rounded
        once to ``p``'s dtype (:func:`csr_mean_bf16` for bf16,
        :func:`csr_mean_f32` for f32), over the degree that :meth:`mean` of
        the ``of`` input divides by (given, or counted as there), not
        rounded to bf16.  ``p``'s width is a multiple of ``VECTOR[p.dtype]``."""
        index, deg = self.index(), self._row_degree(of)
        if p.dtype == torch.bfloat16:
            return csr_mean_bf16(p, index, deg)
        return csr_mean_f32(p, index, deg)

    def _row_degree(self, dtype: torch.dtype) -> torch.Tensor:
        """The degree a forward mean of a ``dtype`` input divides by: the
        given one, else the row index's count, which a bf16 sum of ones
        stops at :data:`BF16_COUNT_MAX`."""
        if self.deg is not None:
            return self.deg
        deg = self.index().indptr.diff()
        return torch.clamp(deg, max=BF16_COUNT_MAX) if dtype == torch.bfloat16 else deg


def spmm_mean(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              num_nodes: int, in_deg: Optional[torch.Tensor] = None,
              chunk: int = SPMM_CHUNK) -> torch.Tensor:
    """Mean aggregation: sum / in-degree (degree from dst if not given), as
    :meth:`FullGraph.mean` of these edges takes it."""
    return FullGraph(src, dst, num_nodes, in_deg, chunk).mean(h)


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

"""Node-space sharding, ``--node-shard`` (port of
``falcon_ttdforgnns_tpu/parallel/node_sharding.py``).

The node space is cut into S blocks of ``block`` storage rows, one block a
rank of the node axis (:class:`.mesh.NodeMesh`): every rank holds only its
block's activations, and each layer aggregates as a **ring SpMM**.  A rank
first sums the edges from its own block into its rows, then S-1 times
passes the block it holds to its left neighbour and takes the one of its
right neighbour (``torch.distributed.batch_isend_irecv``: NCCL on the card,
gloo on the CPU), summing the edges from that block into its rows.  At
rotation i rank j holds block (j + i) % S, as in JAX (``:130-131``).
Every edge is summed once, into the rank that owns its destination.

The host layouts are the JAX package's numpy code, copied function for
function, and give its arrays bit for bit:

- :func:`partition_edges_by_block`, the dense (S, S, E_max) buckets;
- :func:`partition_edges_ragged`, the production layout (O(E + S^2 chunk)
  indices, rows dealt to shards by :func:`balanced_row_assignment`).

What one rank sums at each rotation is a :class:`RingShard`, made from
either layout (:func:`dense_shard`, :func:`ragged_shard`), so one ring,
:func:`ring_spmm`, serves both of JAX's (``ring_spmm`` and
``ring_spmm_ragged``), and one :func:`sharded_layerwise_inference` both of
its inference functions.  A ragged rotation's bucket is summed as one
slice of its real edges, cut into ``edge_chunk`` pieces for memory only:
JAX's per-chunk ``scan`` with its redirect and mask (``:335-346``) exists
to keep SPMD shapes static and would be one launch a chunk here.  The sum
is ``index_add_`` in f32, as JAX's is an XLA scatter-add
(``acc.at[d].add``), not a Pallas kernel.

The ring is an ``autograd.Function`` whose backward is the transposed
ring: the gradient accumulator travels the other way, S-1 rotations, each
rank adding the transposed sum of the bucket it consumed at that
rotation, which is what JAX's transpose of ``ppermute`` inside ``scan``
computes.  It saves no messages, only the shard.

:class:`NodeSharding` is the node-sharded full-neighbour step's and the
sharded inference's state on one rank (the counterpart of
``make_node_sharded_full_step``, ``:401-473``): its block of the layout
on the device, the node ids and degrees of its rows, the seeds of a batch
that fall in its rows, and the one all-reduce a step over both axes.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .data_parallel import reduce_sums
from .mesh import NodeMesh, check_backend, checked_world, make_mesh, resolve_data_shards


def partition_edges_by_block(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                             num_shards: int,
                             pad_multiple: int = 1024):
    """Group edges into (src_block, dst_block) buckets, padded to a common
    static size.

    Returns (src_b, dst_b, w_b) with shape (S, S, E_max): bucket [s, d]
    holds edges whose src lives in block s and dst in block d, with
    *block-local* src/dst indices; w is 1.0 for real edges, 0.0 padding.
    Layout [d][s] is row-major by dst shard so shard d's slice is
    (S, E_max) — one bucket per rotation step.
    """
    block = -(-num_nodes // num_shards)
    sb = (src // block).astype(np.int32)
    db = (dst // block).astype(np.int32)
    order = np.lexsort((sb, db))
    src_s, dst_s = src[order], dst[order]

    counts = np.bincount((db[order].astype(np.int64) * num_shards
                          + sb[order]),
                         minlength=num_shards * num_shards)
    e_max = int(np.ceil(counts.max() / pad_multiple) * pad_multiple) if counts.max() else pad_multiple

    # all S^2 buckets pad to the hottest bucket: on skewed (power-law)
    # graphs without a balancing reorder the waste can be several x E —
    # surface it rather than silently allocate
    pad_ratio = num_shards * num_shards * e_max / max(len(src), 1)
    # tiny graphs inflate the ratio via pad_multiple rounding alone — only
    # warn when the waste is real memory
    if pad_ratio > 4.0 and len(src) > 1_000_000:
        warnings.warn(
            f"ring-SpMM bucket padding is {pad_ratio:.1f}x the edge count "
            f"(hottest bucket {int(counts.max())} of {len(src)} edges); a "
            f"balancing reorder (--partition) shrinks the skew")

    src_b = np.zeros((num_shards, num_shards, e_max), np.int32)
    dst_b = np.zeros((num_shards, num_shards, e_max), np.int32)
    w_b = np.zeros((num_shards, num_shards, e_max), np.float32)
    offs = np.cumsum(counts)
    start = 0
    for d in range(num_shards):
        for s in range(num_shards):
            end = offs[d * num_shards + s]
            n = end - start
            if n > 0:
                src_b[d, s, :n] = src_s[start:end] - s * block
                dst_b[d, s, :n] = dst_s[start:end] - d * block
                w_b[d, s, :n] = 1.0
            start = end
    return src_b, dst_b, w_b, block


@dataclass(frozen=True)
class RaggedRingLayout:
    """Host-side ragged edge layout for the ring (JAX ``:149``).

    ``src_r``/``dst_r`` are (S, E_pad): row d holds dst-shard d's
    edges, grouped by src block in ROTATION order (src block (d+i) % S at
    chunk offsets [chunk_offs[d, i], chunk_offs[d, i+1])), each bucket
    padded to a ``chunk`` multiple; the final chunk of every row is the
    redirect target for shards with fewer chunks at a step.  ``nreal``
    (S, S) holds each (dst-shard, rotation) bucket's REAL edge count.
    Indices are block-local storage rows.  ``row_of[v]`` is node v's
    storage row (shard = row // block); ``node_at[r]`` inverts it (pad rows
    clamped to 0).  ``max_chunks[i]`` is the (max over shards) chunk count
    of rotation step i.
    """

    src_r: np.ndarray
    dst_r: np.ndarray
    nreal: np.ndarray
    chunk_offs: np.ndarray
    max_chunks: Tuple[int, ...]
    chunk: int
    block: int
    num_shards: int
    num_edges: int
    row_of: np.ndarray
    node_at: np.ndarray

    @property
    def num_rows_padded(self) -> int:
        return self.block * self.num_shards

    @property
    def memory_ratio(self) -> float:
        """Stored index elements per real edge (per index array)."""
        return self.src_r.size / max(self.num_edges, 1)


def balanced_row_assignment(in_deg: np.ndarray, num_shards: int
                            ) -> Tuple[np.ndarray, int]:
    """Assign nodes to shards balancing per-shard in-degree sums: sort by
    in-degree descending, deal in snake order (0..S-1, S-1..0, ...) — LPT-
    style, so per-shard edge totals stay ~E/S even on power-law graphs.
    Returns (row_of, block): node v is stored at row ``row_of[v]`` and
    owned by shard ``row_of[v] // block``."""
    n = len(in_deg)
    order = np.argsort(-in_deg, kind="stable")
    block = -(-n // num_shards)
    fwd = np.arange(num_shards)
    snake = np.concatenate([fwd, fwd[::-1]])
    shard_of_rank = np.tile(snake, n // (2 * num_shards) + 1)[:n]
    slot_of_rank = np.zeros(n, np.int64)
    for s in range(num_shards):
        m = shard_of_rank == s
        slot_of_rank[m] = np.arange(int(m.sum()))
    row_of = np.empty(n, np.int64)
    row_of[order] = shard_of_rank.astype(np.int64) * block + slot_of_rank
    return row_of, block


def partition_edges_ragged(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                           num_shards: int, chunk: Optional[int] = None,
                           balance: bool = True) -> RaggedRingLayout:
    """Ragged per-shard edge layout: O(E + S^2 * chunk) memory instead of
    the dense bucket layout's O(S^2 * E_max).

    With ``balance`` (default) rows are assigned to shards by
    :func:`balanced_row_assignment`, which keeps every shard's edge count
    near E/S regardless of degree skew — the dense layout's "several x E"
    warning case (unreordered RMAT) stays within ~1.1x here.

    ``chunk=None`` auto-sizes the chunk so per-bucket rounding waste stays
    a small fraction of E (power of two in [8, 2048])."""
    E = len(src)
    S = num_shards
    if chunk is None:
        chunk = int(min(2048, max(8, 2 ** int(np.ceil(np.log2(
            max(E // (S * S * 4), 1)))))))
    if balance:
        in_deg = np.bincount(dst, minlength=num_nodes).astype(np.int64)
        row_of, block = balanced_row_assignment(in_deg, S)
    else:
        row_of = np.arange(num_nodes, dtype=np.int64)
        block = -(-num_nodes // S)
    # Memory discipline: every O(E) temporary is dropped as soon as its
    # narrow successor exists, which keeps peak E-bytes near (caller's
    # src,dst 16) + (block-local int32 pair 8) + (int32 key 4) + (argsort
    # order 8) = 36/E.
    r = row_of[src]
    src_l = (r % block).astype(np.int32)
    sb = (r // block).astype(np.int32)
    del r
    r = row_of[dst]
    dst_l = (r % block).astype(np.int32)
    db = (r // block).astype(np.int32)
    del r
    # bucket key: dst shard major, then src block in that shard's ROTATION
    # order ((sb - db) mod S) — so each shard's buckets concatenate in the
    # order the ring delivers them
    sb -= db
    sb %= S           # in-place: sb becomes the rotation index
    db *= S
    db += sb          # db becomes the int32 bucket key
    del sb
    key = db
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=S * S).reshape(S, S)
    del key, db
    src_l = src_l[order]
    dst_l = dst_l[order]
    del order
    nchunks = -(-counts // chunk)  # ceil; 0 for empty buckets
    row_len = (nchunks.sum(axis=1) * chunk).max() if E else 0
    e_pad = int(row_len) + chunk  # final all-zero chunk = redirect target
    # int32 ceilings: a shard's padded edge count and its buckets' real
    # counts are int32 on the device; GLOBAL edge counts past 2^31 are
    # fine, a single shard or bucket past 2^31 means too few shards for
    # the graph — say so instead of wrapping.
    if e_pad >= 2 ** 31 or int(counts.max()) >= 2 ** 31:
        raise ValueError(
            f"per-shard edge block too large for int32 device indexing "
            f"(e_pad={e_pad}, max bucket={int(counts.max())}); raise "
            f"num_shards above {S}")

    src_r = np.zeros((S, e_pad), np.int32)
    dst_r = np.zeros((S, e_pad), np.int32)
    chunk_offs = np.zeros((S, S + 1), np.int32)
    bucket_starts = np.concatenate([[0], np.cumsum(counts.reshape(-1))])
    for d in range(S):
        pos = 0
        for i in range(S):
            b = d * S + i
            n = counts[d, i]
            if n:
                src_r[d, pos:pos + n] = src_l[bucket_starts[b]:bucket_starts[b + 1]]
                dst_r[d, pos:pos + n] = dst_l[bucket_starts[b]:bucket_starts[b + 1]]
            pos += int(nchunks[d, i]) * chunk
            chunk_offs[d, i + 1] = pos // chunk
    max_chunks = tuple(int(c) for c in nchunks.max(axis=0))
    node_at = np.zeros(S * block, np.int32)
    node_at[row_of] = np.arange(num_nodes, dtype=np.int32)
    return RaggedRingLayout(src_r, dst_r, counts.astype(np.int32),
                            chunk_offs, max_chunks,
                            chunk, block, S, E, row_of, node_at)


def node_mesh_for(cfg, device, group=None) -> Optional[NodeMesh]:
    """The ``(data, node)`` mesh of a trainer of ``cfg`` on ``device``, or
    None for the single-device path.  As JAX shards the node space only
    when ``device_count() > 1`` (``trainer.py:367``), ``--node-shard`` on a
    default group of one rank (or none) is the single-device path; a
    ``group`` given explicitly is taken at any size.  The node axis is
    the whole group, but under ``--dist --full-neighbor`` (the hybrid data
    x node split, ``trainer.py:365-375``), where ``--data-shards`` or the
    host count sets the data axis; sampled training evaluates over a node
    axis of the whole group (``trainer.py:1134-1137``)."""
    if not cfg.node_shard:
        return None
    n = checked_world(cfg.num_chips, group)
    if group is None and n == 1:
        return None
    check_backend(group, device, "--node-shard")
    n_data = (resolve_data_shards(n, cfg.data_shards, cfg.batch_size)
              if cfg.dist and not cfg.use_sample else 1)
    return make_mesh(n_data, n // n_data, group)


# (src, dst, w): block-local source rows in the delivered block, the
# destination rows in this shard's block, and the edge weights (None: 1)
Piece = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


@dataclass(frozen=True)
class RingShard:
    """What shard ``index`` of ``num_shards`` sums at each rotation:
    ``buckets[i]`` are the pieces of the edges from block
    ``(index + i) % num_shards`` into its rows, on the device."""

    index: int
    num_shards: int
    buckets: Tuple[Tuple[Piece, ...], ...]


def _pieces(src: torch.Tensor, dst: torch.Tensor, w: Optional[torch.Tensor],
            edge_chunk: int) -> Tuple[Piece, ...]:
    return tuple((src[s:s + edge_chunk], dst[s:s + edge_chunk],
                  None if w is None else w[s:s + edge_chunk])
                 for s in range(0, src.shape[0], edge_chunk))


def dense_shard(src_b: np.ndarray, dst_b: np.ndarray, w_b: np.ndarray, index: int,
                device, edge_chunk: int = 1 << 22) -> RingShard:
    """Shard ``index``'s buckets of :func:`partition_edges_by_block`:
    at rotation i its (src block (index + i) % S) bucket, padding and
    weights included (JAX ``ring_spmm``'s ``accum``)."""
    S = src_b.shape[0]
    buckets = []
    for i in range(S):
        k = (index + i) % S
        src, dst, w = (torch.as_tensor(a[index, k]).to(device) for a in (src_b, dst_b, w_b))
        buckets.append(_pieces(src, dst, w, edge_chunk))
    return RingShard(index, S, tuple(buckets))


def ragged_shard(layout: RaggedRingLayout, index: int, device,
                 edge_chunk: int = 1 << 22) -> RingShard:
    """Shard ``index``'s row of :func:`partition_edges_ragged`: at rotation
    i the real edges of its bucket, ``[chunk_offs[index, i] * chunk, +
    nreal[index, i])`` of the row (its padding is never read), sorted on
    the device by destination row, stably, so that the sum writes (and its
    transpose reads) each row's messages in one run and adds them in the
    layout's order; cut into ``edge_chunk`` pieces."""
    S, chunk = layout.num_shards, layout.chunk
    buckets = []
    for i in range(S):
        lo = int(layout.chunk_offs[index, i]) * chunk
        hi = lo + int(layout.nreal[index, i])
        dst, order = torch.sort(torch.as_tensor(layout.dst_r[index, lo:hi]).to(device),
                                stable=True)
        src = torch.as_tensor(layout.src_r[index, lo:hi]).to(device).index_select(0, order)
        del order
        buckets.append(_pieces(src, dst, None, edge_chunk))
    return RingShard(index, S, tuple(buckets))


def consume(acc: torch.Tensor, rot: torch.Tensor, pieces: Sequence[Piece]) -> torch.Tensor:
    """The local sum of one rotation: ``acc[dst] += w * rot[src]`` over the
    bucket's pieces, in ``acc``'s dtype (f32); returns ``acc``."""
    for src, dst, w in pieces:
        msgs = rot.index_select(0, src)
        if w is not None:
            msgs = msgs * w[:, None]
        acc.index_add_(0, dst, msgs.to(acc.dtype))
    return acc


def consume_transposed(acc: torch.Tensor, g: torch.Tensor,
                       pieces: Sequence[Piece]) -> torch.Tensor:
    """The transpose of :func:`consume`: ``acc[src] += w * g[dst]``, the
    gradient of the delivered block from this shard's output gradient."""
    for src, dst, w in pieces:
        msgs = g.index_select(0, dst)
        if w is not None:
            msgs = msgs * w[:, None]
        acc.index_add_(0, src, msgs.to(acc.dtype))
    return acc


class _RingSpmm(torch.autograd.Function):
    """The ring (forward) and the transposed ring (backward)."""

    @staticmethod
    def forward(ctx, h, shard: RingShard, mesh: NodeMesh):
        ctx.shard, ctx.mesh = shard, mesh
        acc = consume(torch.zeros(h.shape, dtype=torch.float32, device=h.device), h,
                      shard.buckets[0])
        rot = h
        for i in range(1, shard.num_shards):
            rot = mesh.rotate(rot)  # block (index + i) % S, from the right
            consume(acc, rot, shard.buckets[i])
        return acc.to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        shard, mesh = ctx.shard, ctx.mesh
        g = g.contiguous()
        # the accumulator of block (index + i) % S, passed to the right
        # after each rotation, comes home (i = 0) with every shard's share
        acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for i in range(shard.num_shards - 1, 0, -1):
            consume_transposed(acc, g, shard.buckets[i])
            acc = mesh.rotate(acc, back=True)
        consume_transposed(acc, g, shard.buckets[0])
        return acc.to(g.dtype), None, None


def ring_spmm(h: torch.Tensor, shard: RingShard, mesh: NodeMesh) -> torch.Tensor:
    """``out[r] = sum_{(u->v): row v = r} w * h[row u]`` for this rank's
    rows ``r`` of the node axis, ``h`` (block, D) being its block of the
    row-sharded activations; every rank of the node group calls it at
    once.  Differentiable in ``h``: the backward is the transposed ring."""
    if shard.num_shards != mesh.n_node or shard.index != mesh.node_index:
        raise ValueError(f"shard {shard.index} of {shard.num_shards} on node rank "
                         f"{mesh.node_index} of {mesh.n_node}")
    return _RingSpmm.apply(h, shard, mesh)


def sharded_layerwise_inference(h: torch.Tensor, shard: RingShard, mesh: NodeMesh,
                                in_deg: torch.Tensor, apply_conv: Callable,
                                num_layers: int) -> torch.Tensor:
    """Layer-wise full-neighbour inference with node-sharded activations
    (JAX ``sharded_layerwise_inference`` and its ``_ragged`` form): each
    layer is the ring divided by ``max(in_deg, 1)`` of this rank's rows,
    then ``apply_conv(h, agg, layer)``, row-parallel."""
    deg = torch.clamp(in_deg, min=1.0)[:, None]
    for li in range(num_layers):
        h = apply_conv(h, ring_spmm(h, shard, mesh) / deg, li)
    return h


class NodeSharding:
    """One rank's part of node-sharded full-neighbour training and
    inference over ``layout`` (JAX ``make_node_sharded_full_step`` and
    ``infer_full_sharded``): its block's shard of the layout, the node id
    of each of its rows (``node_at``, pad rows clamped to node 0) and
    their padded degrees, on ``device``.  Everything runs in storage-row
    order."""

    def __init__(self, mesh: NodeMesh, layout: RaggedRingLayout, degrees: np.ndarray,
                 device, edge_chunk: int = 1 << 22):
        self.mesh, self.layout = mesh, layout
        j, block = mesh.node_index, layout.block
        self.rows = slice(j * block, (j + 1) * block)
        self.shard = ragged_shard(layout, j, device, edge_chunk)
        self.node_ids = torch.as_tensor(layout.node_at[self.rows]).to(device)
        deg = np.ones(layout.num_rows_padded, np.float32)
        deg[layout.row_of] = degrees
        self.deg = torch.as_tensor(deg[self.rows]).to(device)
        self.device = torch.device(device)

    def propagate(self, h: torch.Tensor, apply_conv: Callable, num_layers: int) -> torch.Tensor:
        """The L layers from this rank's features ``h`` (block, D): its
        rows of the last layer's output."""
        return sharded_layerwise_inference(h, self.shard, self.mesh, self.deg, apply_conv,
                                           num_layers)

    def local_seeds(self, seed_rows: np.ndarray, labels: np.ndarray):
        """The seeds of a batch (their storage rows and labels, host
        arrays of the global batch) that this rank's loss takes: those of
        its data group's slice of the batch whose rows fall in its block,
        as rows of the block and their labels, on the device."""
        m = self.mesh
        per = len(seed_rows) // m.n_data
        part = slice(m.data_index * per, (m.data_index + 1) * per)
        rows, labels = seed_rows[part], labels[part]
        mine = rows // self.layout.block == m.node_index
        return (torch.as_tensor(rows[mine] - self.rows.start).to(self.device),
                torch.as_tensor(labels[mine].astype(np.int64)).to(self.device))

    @staticmethod
    def loss_shares(logits: torch.Tensor, labels: torch.Tensor, batch_size: int):
        """This rank's shares of the global batch's mean loss and accuracy:
        its seeds' sums over the global batch size."""
        loss = F.cross_entropy(logits, labels, reduction="sum") / batch_size
        acc = (logits.detach().argmax(-1) == labels).float().sum() / batch_size
        return loss, acc

    def all_reduce(self, loss: torch.Tensor, acc: torch.Tensor,
                   grads: Sequence[torch.Tensor]):
        """Sum every rank's shares over both axes, in one all-reduce."""
        return reduce_sums(loss, acc, grads, self.mesh.group)

    def gather_rows(self, out: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``out`` (block, C) over the node axis, in
        node order: the (N, C) result on every rank of the group."""
        m = self.mesh
        if m.n_node == 1:
            full = out
        else:
            parts: List[torch.Tensor] = [torch.empty_like(out) for _ in range(m.n_node)]
            dist.all_gather(parts, out.contiguous(), group=m.node_group)
            full = torch.cat(parts)
        return full.index_select(0, torch.as_tensor(self.layout.row_of).to(out.device))

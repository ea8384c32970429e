"""Tiled SpMM (``--spmm pallas``): the host tilers, the wrappers of the
Hopper kernels ``spmm_seg_mm`` and ``spmm_tile_sum`` (``csrc/spmm_kernels.cu``)
and their plain PyTorch versions.

Port of ``falcon_ttdforgnns_tpu/ops/spmm_pallas.py``:

==========================  =================================  =======================
wrapper                     replaces (TPU kernel)              launch count
==========================  =================================  =======================
``spmm_sum_tiled_uniform``  ``_seg_mm_kernel``                 ``spmm_tiled``
``spmm_sum_tiled_arrays``   ``_seg_mm_kernel``                 ``spmm_tiled``
``spmm_sum_tiled``          ``_seg_mm_kernel``                 ``spmm_tiled``
``spmm_sum_tile_partials``  ``_tile_mm_kernel``                ``spmm_tile_partials``
==========================  =================================  =======================

With ``compute_dtype=torch.bfloat16`` the counts are ``spmm_tiled[bf16]``
and ``spmm_tile_partials[bf16]``.

The tilers are numpy copies of the reference's, array for array.  Dst-
sorted edges are cut into tiles of at most E_t slots (src, dstl, w) whose
dst rows lie in one NR-row output block; every block gets at least one
tile.  The TPU needed two things the card does not: ``first`` flags (its
grid ran tile after tile and carried a block's sum in VMEM) and chunks (to
bound the messages ``h[src]`` gathered before the kernel).  The Hopper
kernel sums each block's tiles inside one CTA and reads ``h`` itself, so
the wrappers take neither: a block's value is the sum of its tiles.  For
the uniform tiling the result is the reference's scan, in which a chunk's
pad blocks are overwritten by the next chunk: each block comes from the
last chunk in order that covers it.

``spmm_sum_tile_partials`` keeps the reference's two stages only in its
plain version (:func:`tile_mm_plain`, one (NR, D) partial per tile, then
:func:`_sum_partials` by block id), which the tests hold to JAX and the
kernel to.  On the card there are no partials: one memset zeroes the
(num_nodes, D) output and one kernel adds every slot's ``w * h[src]``
into its row with vector atomics at the end of each run of one row.

Precision: the reference gathers and multiplies in bf16 on a TPU and in
f32 in interpret mode.  The port computes in f32 on both devices by
default; ``compute_dtype=torch.bfloat16`` rounds ``h`` and ``w`` to bf16
(products exact in f32, sums in f32), as the reference's TPU path does.
The output is f32 either way.  A wrapper runs the plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _build

KERNELS = ("spmm_tiled", "spmm_tiled[bf16]", "spmm_tile_partials",
           "spmm_tile_partials[bf16]")
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


# ------------------------------------------------------------------ tilers
@dataclass
class SpmmTiles:
    """Host-precomputed tiling of a dst-sorted COO edge list."""

    src: np.ndarray      # (T*E_t,) int32 gather ids (0 for padding)
    dstl: np.ndarray     # (T*E_t,) int32 dst row within the tile's block
    w: np.ndarray        # (T*E_t,) f32 edge weight, 0 for padding
    blk: np.ndarray      # (T,) int32 out block id per tile
    first: np.ndarray    # (T,) int32 1 = first tile of its block
    chunks: List[Tuple[int, int, int, int]]  # (t0, t1, blk0, n_blocks)
    num_blocks: int
    block_rows: int      # NR
    tile_edges: int      # E_t


def build_spmm_tiles(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                     edge_weight: Optional[np.ndarray] = None,
                     block_rows: int = 128, tile_edges: int = 2048,
                     max_chunk_tiles: int = 8192) -> SpmmTiles:
    """Tile dst-SORTED edges (``spmm_pallas.py:build_spmm_tiles``); chunks
    are cut at block boundaries, at most ``max_chunk_tiles`` tiles each
    unless a block's run is longer."""
    NR, E_t = block_rows, tile_edges
    E = len(src)
    if len(dst) != E:
        raise ValueError(f"src and dst differ in length: {E} and {len(dst)}")
    nb = -(-num_nodes // NR)
    w = (edge_weight if edge_weight is not None
         else np.ones(E, np.float32)).astype(np.float32)

    eblk = dst // NR
    counts = np.bincount(eblk, minlength=nb)
    tiles_per_block = np.maximum(1, -(-counts // E_t))
    T = int(tiles_per_block.sum())

    src_p = np.zeros(T * E_t, np.int32)
    dstl_p = np.zeros(T * E_t, np.int32)
    w_p = np.zeros(T * E_t, np.float32)
    blk = np.zeros(T, np.int32)
    first = np.zeros(T, np.int32)

    estart = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=estart[1:])
    t = 0
    for b in range(nb):
        e0, e1 = estart[b], estart[b + 1]
        for k in range(tiles_per_block[b]):
            lo = e0 + k * E_t
            hi = min(e1, lo + E_t)
            m = hi - lo
            o = t * E_t
            if m > 0:
                src_p[o:o + m] = src[lo:hi]
                dstl_p[o:o + m] = dst[lo:hi] - b * NR
                w_p[o:o + m] = w[lo:hi]
            blk[t] = b
            first[t] = 1 if k == 0 else 0
            t += 1

    chunks: List[Tuple[int, int, int, int]] = []
    t0 = 0
    while t0 < T:
        t1 = min(T, t0 + max_chunk_tiles)
        while t1 < T and first[t1] == 0:  # never split a block's run
            t1 += 1
        blk0 = int(blk[t0])
        chunks.append((t0, t1, blk0, int(blk[t1 - 1]) - blk0 + 1))
        t0 = t1
    return SpmmTiles(src=src_p, dstl=dstl_p, w=w_p, blk=blk, first=first,
                     chunks=chunks, num_blocks=nb, block_rows=NR, tile_edges=E_t)


def auto_tile_edges(num_edges: int, num_nodes: int, block_rows: int = 128) -> int:
    """E_t near the average edges per block, in {1024, 2048}
    (``spmm_pallas.py:auto_tile_edges``)."""
    avg = num_edges / max(1, -(-num_nodes // block_rows))
    return 2048 if avg > 1536 else 1024


@dataclass
class SpmmTilesU:
    """Uniform-chunk tiling: every chunk has TC tiles and covers NBC
    blocks; pad tiles (w = 0) zero-define the blocks past a chunk's own,
    which the next chunk then overwrites."""

    src: np.ndarray      # (C, TC*E_t) int32
    dstl: np.ndarray     # (C, TC*E_t) int32
    w: np.ndarray        # (C, TC*E_t) f32
    blkl: np.ndarray     # (C, TC) int32 chunk-local block ids
    first: np.ndarray    # (C, TC) int32
    blk0: np.ndarray     # (C,) int32 first global block of the chunk
    num_blocks_padded: int
    blocks_per_chunk: int   # NBC
    block_rows: int         # NR
    tile_edges: int         # E_t


def build_spmm_tiles_uniform(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                             edge_weight: Optional[np.ndarray] = None,
                             block_rows: int = 128, tile_edges: int = 2048,
                             tiles_per_chunk: int = 1024) -> SpmmTilesU:
    """Uniform-chunk tiler over dst-SORTED edges
    (``spmm_pallas.py:build_spmm_tiles_uniform``)."""
    flat = build_spmm_tiles(src, dst, num_nodes, edge_weight, block_rows,
                            tile_edges, max_chunk_tiles=tiles_per_chunk)
    NR, E_t = block_rows, tile_edges
    chunks = flat.chunks
    C = len(chunks)
    NBC = max(nblk for (_, _, _, nblk) in chunks)
    TC = max((t1 - t0) + (NBC - nblk) for (t0, t1, _, nblk) in chunks)

    src_u = np.zeros((C, TC * E_t), np.int32)
    dstl_u = np.zeros((C, TC * E_t), np.int32)
    w_u = np.zeros((C, TC * E_t), np.float32)
    blkl_u = np.zeros((C, TC), np.int32)
    first_u = np.zeros((C, TC), np.int32)
    blk0_u = np.zeros(C, np.int32)
    for c, (t0, t1, blk0, nblk) in enumerate(chunks):
        nt = t1 - t0
        src_u[c, :nt * E_t] = flat.src[t0 * E_t:t1 * E_t]
        dstl_u[c, :nt * E_t] = flat.dstl[t0 * E_t:t1 * E_t]
        w_u[c, :nt * E_t] = flat.w[t0 * E_t:t1 * E_t]
        blkl_u[c, :nt] = flat.blk[t0:t1] - blk0
        first_u[c, :nt] = flat.first[t0:t1]
        blk0_u[c] = blk0
        for j in range(NBC - nblk):  # pad tiles zero-define blocks [nblk, NBC)
            blkl_u[c, nt + j] = nblk + j
            first_u[c, nt + j] = 1
        for j in range(nt + (NBC - nblk), TC):  # the rest revisit the last block, w = 0
            blkl_u[c, j] = NBC - 1
    nbp = int(blk0_u[-1]) + NBC
    return SpmmTilesU(src=src_u, dstl=dstl_u, w=w_u, blkl=blkl_u, first=first_u,
                      blk0=blk0_u, num_blocks_padded=nbp, blocks_per_chunk=NBC,
                      block_rows=NR, tile_edges=E_t)


# ------------------------------------------------------------ plain version
def _scatter_tiles_plain(out: torch.Tensor, h_g: torch.Tensor, src: torch.Tensor,
                         dstl: torch.Tensor, w: torch.Tensor, tile_row0: torch.Tensor,
                         E_t: int, NR: int, bf16_w: bool,
                         tiles_per_pass: int = 1024) -> torch.Tensor:
    """out[tile_row0[t] + dstl[e]] += w[e] * h_g[src[e]] over the slots e of
    every tile t, in f32; slots whose dstl is outside [0, NR) add nothing
    (the reference's one-hot matches no row).  Passes of
    ``tiles_per_pass`` tiles bound the gathered messages."""
    for t0 in range(0, tile_row0.shape[0], tiles_per_pass):
        t1 = min(tile_row0.shape[0], t0 + tiles_per_pass)
        sl = slice(t0 * E_t, t1 * E_t)
        d = dstl[sl].long()
        ww = w[sl].to(torch.bfloat16).float() if bf16_w else w[sl]
        rows = tile_row0[t0:t1].long().repeat_interleave(E_t) + d
        ok = (d >= 0) & (d < NR)
        msgs = h_g.index_select(0, src[sl].long()).float() * ww[:, None]
        out.index_add_(0, rows[ok], msgs[ok])
    return out


def _gather_dtype(h: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h must be float32 or bfloat16, not {h.dtype}")
    return h.to(torch.bfloat16) if compute_dtype == torch.bfloat16 else h


def seg_mm_plain(h: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                 w: torch.Tensor, blkl: torch.Tensor, blk0: torch.Tensor,
                 num_blocks_padded: int, blocks_per_chunk: int, block_rows: int,
                 tile_edges: int, compute_dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """The reference's scan, chunk by chunk: each chunk's (NBC*NR, D) sum
    of its tiles overwrites its rows of the zeroed output.  Arrays as in
    :class:`SpmmTilesU`, as tensors; returns (num_blocks_padded*NR, D) f32."""
    NR, E_t, NBC = block_rows, tile_edges, blocks_per_chunk
    h_g = _gather_dtype(h, compute_dtype)
    bf16_w = compute_dtype == torch.bfloat16
    out_rows = num_blocks_padded * NR
    out = torch.zeros((out_rows, h.shape[1]), dtype=torch.float32, device=h.device)
    for c in range(src.shape[0]):
        part = torch.zeros((NBC * NR, h.shape[1]), dtype=torch.float32, device=h.device)
        _scatter_tiles_plain(part, h_g, src[c], dstl[c], w[c], blkl[c] * NR, E_t, NR,
                             bf16_w)
        r0 = int(blk0[c]) * NR
        n = min(NBC * NR, out_rows - r0)
        out[r0:r0 + n] = part[:n]
    return out


def tile_mm_plain(h: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                  w: torch.Tensor, block_rows: int, tile_edges: int,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One (NR, D) f32 partial per tile: (T*NR, D)."""
    NR, E_t = block_rows, tile_edges
    T = src.shape[0] // E_t
    h_g = _gather_dtype(h, compute_dtype)
    out = torch.zeros((T * NR, h.shape[1]), dtype=torch.float32, device=h.device)
    return _scatter_tiles_plain(out, h_g, src, dstl, w,
                                torch.arange(T, device=h.device) * NR, E_t, NR,
                                compute_dtype == torch.bfloat16)


# ----------------------------------------------------------------- kernels
def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"the SpMM kernels take tensors on one CUDA device or on "
                         f"the CPU, got {sorted(str(t.device) for t in tensors)}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, numel: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} values, got {t.numel()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_h(h: torch.Tensor) -> None:
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous (N, D) tensor, got {tuple(h.shape)}")


def _launch_seg_mm(h, src, dstl, w, blkl, blk0, out_rows, NBC, NR, E_t, compute_dtype):
    """One launch over every chunk: (out_rows, D) f32."""
    h_g = _gather_dtype(h, compute_dtype)
    _check_h(h_g)
    C, TC = blkl.shape
    for name, t, dt, n in (("src", src, torch.int32, C * TC * E_t),
                           ("dstl", dstl, torch.int32, C * TC * E_t),
                           ("w", w, torch.float32, C * TC * E_t),
                           ("blkl", blkl, torch.int32, C * TC), ("blk0", blk0, torch.int32, C)):
        _check(t, name, dt, n)
    if bool((blkl[:, 1:] < blkl[:, :-1]).any()) or bool((blk0[1:] < blk0[:-1]).any()):
        raise ValueError("block ids must be non-decreasing within each chunk, and "
                         "chunks in block order (as the tilers make them)")
    out = torch.zeros((out_rows, h.shape[1]), dtype=torch.float32, device=h.device)
    bf16 = compute_dtype == torch.bfloat16
    rc = _build.library("spmm_kernels").spmm_seg_mm(
        h_g.data_ptr(), int(h_g.dtype == torch.bfloat16), h_g.shape[0], h_g.shape[1],
        src.data_ptr(), dstl.data_ptr(), w.data_ptr(), blkl.data_ptr(), blk0.data_ptr(),
        C, TC, NBC, NR, E_t, int(bf16), out.data_ptr(), out_rows,
        _build.current_stream(h.get_device()))
    _build.check(rc, "spmm_seg_mm", "spmm_kernels")
    _launches["spmm_tiled[bf16]" if bf16 else "spmm_tiled"] += 1
    return out


# ----------------------------------------------------------------- wrappers
def spmm_sum_tiled_uniform(h: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                           w: torch.Tensor, blkl: torch.Tensor, blk0: torch.Tensor,
                           num_blocks_padded: int, blocks_per_chunk: int,
                           block_rows: int, tile_edges: int, num_nodes: int,
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[v] = sum_{u->v} w * h[u] over a uniform tiling (the arrays of
    :class:`SpmmTilesU` as tensors, without ``first``): (num_nodes, D) f32."""
    if _on_cpu(h, src, dstl, w, blkl, blk0):
        return seg_mm_plain(h, src, dstl, w, blkl, blk0, num_blocks_padded,
                            blocks_per_chunk, block_rows, tile_edges,
                            compute_dtype)[:num_nodes]
    return _launch_seg_mm(h, src, dstl, w, blkl, blk0, num_blocks_padded * block_rows,
                          blocks_per_chunk, block_rows, tile_edges,
                          compute_dtype)[:num_nodes]


def spmm_sum_tiled_arrays(h: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                          w: torch.Tensor, blk: torch.Tensor, num_blocks: int,
                          block_rows: int, tile_edges: int, num_nodes: int,
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The flat tiling (:class:`SpmmTiles`'s ``src``, ``dstl``, ``w``,
    ``blk`` as tensors): one chunk of every tile, so the same kernel and
    plain version as the uniform tiling."""
    blkl = blk.reshape(1, -1)
    blk0 = torch.zeros(1, dtype=blk.dtype, device=blk.device)
    src, dstl, w = (a.reshape(1, -1) for a in (src, dstl, w))
    if _on_cpu(h, src, dstl, w, blkl):
        return seg_mm_plain(h, src, dstl, w, blkl, blk0, num_blocks, num_blocks,
                            block_rows, tile_edges, compute_dtype)[:num_nodes]
    return _launch_seg_mm(h, src, dstl, w, blkl, blk0, num_blocks * block_rows,
                          num_blocks, block_rows, tile_edges, compute_dtype)[:num_nodes]


def spmm_sum_tiled(h: torch.Tensor, tiles: SpmmTiles, num_nodes: int,
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[v] = sum_{u->v} w * h[u] from a host :class:`SpmmTiles`."""
    dev = h.device
    return spmm_sum_tiled_arrays(
        h, *(torch.as_tensor(a, device=dev) for a in (tiles.src, tiles.dstl, tiles.w,
                                                      tiles.blk)),
        tiles.num_blocks, tiles.block_rows, tiles.tile_edges, num_nodes, compute_dtype)


def _sum_partials(partials: torch.Tensor, blk: torch.Tensor, num_blocks: int,
                  block_rows: int, num_nodes: int) -> torch.Tensor:
    """The per-tile partials summed by block id (the reference's XLA
    segment sum, outside the kernel)."""
    T, D = blk.shape[0], partials.shape[1]
    per_block = torch.zeros((num_blocks, block_rows * D), dtype=torch.float32,
                            device=partials.device)
    per_block.index_add_(0, blk.long(), partials.view(T, block_rows * D))
    return per_block.view(num_blocks * block_rows, D)[:num_nodes]


def tile_partials_plain(h: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                        w: torch.Tensor, blk: torch.Tensor, num_blocks: int,
                        block_rows: int, tile_edges: int, num_nodes: int,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _sum_partials(tile_mm_plain(h, src, dstl, w, block_rows, tile_edges,
                                       compute_dtype), blk, num_blocks, block_rows, num_nodes)


def spmm_sum_tile_partials(h: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                           w: torch.Tensor, blk: torch.Tensor, num_blocks: int,
                           block_rows: int, tile_edges: int, num_nodes: int,
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[v] = sum_{u->v} w * h[u] over the flat tiling (:class:`SpmmTiles`'s
    ``src``, ``dstl``, ``w``, ``blk`` as tensors): (num_nodes, D) f32.  On
    the CPU the reference's two stages (:func:`tile_partials_plain`); on the
    card one memset and one kernel that adds every slot straight into the
    output, with no per-tile partials and no segment sum."""
    if _on_cpu(h, src, dstl, w, blk):
        return tile_partials_plain(h, src, dstl, w, blk, num_blocks, block_rows, tile_edges,
                                   num_nodes, compute_dtype)
    NR, E_t, D = block_rows, tile_edges, h.shape[1]
    T = blk.shape[0]
    h_g = _gather_dtype(h, compute_dtype)  # bf16 compute gathers bf16 rows, half the bytes
    _check_h(h_g)
    for name, t, dt, n in (("src", src, torch.int32, T * E_t),
                           ("dstl", dstl, torch.int32, T * E_t),
                           ("w", w, torch.float32, T * E_t), ("blk", blk, torch.int32, T)):
        _check(t, name, dt, n)
    out = torch.empty((num_nodes, D), dtype=torch.float32, device=h.device)
    bf16 = compute_dtype == torch.bfloat16
    rc = _build.library("spmm_kernels").spmm_tile_sum(
        h_g.data_ptr(), int(h_g.dtype == torch.bfloat16), h_g.shape[0], D, src.data_ptr(),
        dstl.data_ptr(), w.data_ptr(), blk.data_ptr(), T, NR, E_t,
        int(bf16), out.data_ptr(), num_nodes, _build.current_stream(h.get_device()))
    _build.check(rc, "spmm_tile_sum", "spmm_kernels")
    if T > 0 and num_nodes > 0:
        _launches["spmm_tile_partials[bf16]" if bf16 else "spmm_tile_partials"] += 1
    return out

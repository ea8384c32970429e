"""Window-blocked SpMM (``--spmm blocked``): the host tiler, the wrapper of
the Hopper kernel ``spmm_window_gather`` (``csrc/spmm_kernels.cu``) with its
plain PyTorch version, and the differentiable operator of full-graph GCN.

Port of ``falcon_ttdforgnns_tpu/ops/spmm_blocked.py``.  The host groups
edges, sorted by (dst bucket, src), into tiles of T slots whose sources lie
in one T-row window of ``h`` starting at a multiple of T/2.  The kernel
(replacing ``_gather_kernel``, launch count ``spmm_gather``) writes each
slot's weighted message ``h[win*T/2 + idx] * w`` in ``h``'s dtype, one
chunk of tiles per launch; ``index_add_`` then adds the chunk's messages
into the (N, D) accumulator in that dtype, as the reference's XLA scatter
did outside Pallas.  The backward of :func:`apply_blocked_spmm` is the same
sum over a second tiling with src and dst swapped (d_h = A^T g).

The reference's ``check_blocked_supported`` is a limit of the TPU compiler
(its gather reaches one vector register), not of the card, so it has no
counterpart here.  A wrapper runs the plain version only for tensors on
the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import resolve_device
from . import _build

KERNELS = ("spmm_gather",)
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


class WindowTiles(NamedTuple):
    """Static tiling of an edge list into src-window tiles.

    win:  (n_tiles,) int32  — half-window index; the tile's window is rows
                              [win*T/2, win*T/2 + T) of h
    idx:  (n_tiles, T) int32 — window-local src of each slot
    dst:  (n_tiles, T) int32 — global dst (pad slots -> num_nodes - 1)
    w:    (n_tiles, T) f32   — edge weight, 0.0 for pad slots
    """

    win: np.ndarray
    idx: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    tile: int
    num_nodes: int
    n_real_edges: int


def build_window_tiles(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                       edge_weight: Optional[np.ndarray] = None,
                       tile: int = 4096, dst_buckets: int = 16,
                       chunk_tiles: int = 512) -> WindowTiles:
    """Greedy host tiling (``spmm_blocked.py:build_window_tiles``): edges
    sorted by (dst bucket, src) are packed into tiles of at most ``tile``
    slots whose src span fits one ``tile``-row window aligned to
    ``tile/2``; each dst bucket restarts the walk; the tile count is padded
    to a multiple of ``chunk_tiles``."""
    if tile % 2:
        raise ValueError(f"tile must be even, got {tile}")
    half = tile // 2
    E = len(src)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = (np.asarray(edge_weight, np.float32) if edge_weight is not None
         else np.ones(E, np.float32))

    rb = -(-num_nodes // max(1, dst_buckets))
    key = (dst // rb) * (num_nodes + 1) + src
    order = np.argsort(key)  # the reference's unstable sort: equal keys are interchangeable
    src_s = src.astype(np.int32)[order]
    dst_s = dst.astype(np.int32)[order]
    w_s = w[order]
    bucket_s = dst_s // np.int32(rb)

    bnd = np.flatnonzero(np.diff(bucket_s)) + 1
    bounds = np.concatenate([[0], bnd, [E]])

    wins, slices = [], []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        i, b1 = int(b0), int(b1)
        while i < b1:
            astart = (int(src_s[i]) // half) * half
            # the tile ends by the next `tile` slots: search only those, with
            # an int32 key (a Python int makes numpy copy the slice to int64)
            j_row = int(src_s[i:min(b1, i + tile)].searchsorted(np.int32(astart + tile)))
            j = min(i + tile, i + j_row, b1)
            wins.append(astart // half)
            slices.append((i, j))
            i = j

    n_tiles = len(wins)
    n_pad = -(-max(1, n_tiles) // chunk_tiles) * chunk_tiles
    win = np.zeros(n_pad, np.int32)
    idx = np.zeros((n_pad, tile), np.int32)
    dstt = np.full((n_pad, tile), num_nodes - 1, np.int32)
    wt = np.zeros((n_pad, tile), np.float32)
    for t, ((i, j), wn) in enumerate(zip(slices, wins)):
        n = j - i
        win[t] = wn
        idx[t, :n] = src_s[i:j] - wn * half
        dstt[t, :n] = dst_s[i:j]
        wt[t, :n] = w_s[i:j]
    return WindowTiles(win=win, idx=idx, dst=dstt, w=wt, tile=tile,
                       num_nodes=num_nodes, n_real_edges=E)


def default_blocked_tiling(device) -> Tuple[int, int]:
    """(tile, chunk_tiles): 4096 and 512 on the card, 256 and 8 on the
    CPU (the reference's TPU and interpret-mode sizes; tiling sizes, not
    timings)."""
    return (4096, 512) if torch.device(device).type == "cuda" else (256, 8)


def chunk_tiles_host(tiles: WindowTiles, chunk_tiles: int = 512):
    """Tile metadata as chunk stacks: (n_chunks, CT), then (n_chunks, CT*T)
    for idx, dst and w."""
    nt = tiles.win.shape[0]
    if nt % chunk_tiles:
        raise ValueError(f"n_tiles={nt} must be a multiple of chunk_tiles={chunk_tiles} "
                         f"(build_window_tiles pads to its chunk_tiles argument)")
    nc = nt // chunk_tiles
    T = tiles.tile
    return (tiles.win.reshape(nc, chunk_tiles),
            tiles.idx.reshape(nc, chunk_tiles * T),
            tiles.dst.reshape(nc, chunk_tiles * T),
            tiles.w.reshape(nc, chunk_tiles * T))


# ------------------------------------------------------------ the gather
def window_gather_plain(h: torch.Tensor, win: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, tile: int) -> torch.Tensor:
    """The reference's gather: h padded with zero rows to whole half-windows
    plus one, rows ``win*T/2 + idx``, times ``w`` cast to h's dtype."""
    half = tile // 2
    n_half = -(-h.shape[0] // half) + 1
    h_pad = torch.nn.functional.pad(h, (0, 0, 0, n_half * half - h.shape[0]))
    rows = win.long().repeat_interleave(tile) * half + idx.long()
    return h_pad.index_select(0, rows) * w.to(h.dtype)[:, None]


def window_gather(h: torch.Tensor, win: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor, tile: int) -> torch.Tensor:
    """Weighted messages of one chunk of tiles: win (nt,), idx and w
    (nt*T,) -> (nt*T, D) in h's dtype (f32 or bf16)."""
    if tile <= 0 or tile % 2:
        raise ValueError(f"tile must be even and positive, got {tile}")
    devs = {t.device for t in (h, win, idx, w)}
    if {d.type for d in devs} == {"cpu"}:
        return window_gather_plain(h, win, idx, w, tile)
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"window_gather takes tensors on one CUDA device or on the "
                         f"CPU, got {sorted(str(d) for d in devs)}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h must be float32 or bfloat16, not {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous (N, D) tensor, got {tuple(h.shape)}")
    n_slots = win.numel() * tile
    for name, t, dt, n in (("win", win, torch.int32, win.numel()),
                           ("idx", idx, torch.int32, n_slots),
                           ("w", w, torch.float32, n_slots)):
        if t.dtype != dt or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: expected {n} contiguous {dt}, got {t.numel()} "
                             f"{t.dtype}")
    out = torch.empty((n_slots, h.shape[1]), dtype=h.dtype, device=h.device)
    rc = _build.library("spmm_kernels").spmm_window_gather(
        h.data_ptr(), int(h.dtype == torch.bfloat16), h.shape[0], h.shape[1],
        win.data_ptr(), idx.data_ptr(), w.data_ptr(), tile, n_slots, out.data_ptr(),
        _build.current_stream(h.get_device()))
    _build.check(rc, "spmm_window_gather", "spmm_kernels")
    if n_slots:
        _launches["spmm_gather"] += 1
    return out


def spmm_sum_blocked_dev(h: torch.Tensor, win2: torch.Tensor, idx2: torch.Tensor,
                         dst2: torch.Tensor, w2: torch.Tensor, tile: int,
                         num_nodes: int) -> torch.Tensor:
    """out[v] = sum_{u->v} w_e h[u] from the chunk stacks of
    :func:`chunk_tiles_host` (as tensors on h's device): one gather per
    chunk, added into the (num_nodes, D) accumulator in h's dtype."""
    acc = torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype, device=h.device)
    for c in range(win2.shape[0]):
        acc.index_add_(0, dst2[c], window_gather(h, win2[c], idx2[c], w2[c], tile))
    return acc


def spmm_sum_blocked(h: torch.Tensor, tiles: WindowTiles,
                     chunk_tiles: int = 512) -> torch.Tensor:
    """out[v] = sum_{u->v} w_e h[u] from a host :class:`WindowTiles`."""
    args = (torch.as_tensor(a, device=h.device) for a in chunk_tiles_host(tiles, chunk_tiles))
    return spmm_sum_blocked_dev(h, *args, tiles.tile, tiles.num_nodes)


# ------------------------------------------------- differentiable operator
class BlockedSpmm(NamedTuple):
    """Window-blocked SpMM of a fixed graph: ``fwd`` tiles A, ``bwd`` tiles
    A^T; each is (win2, idx2, dst2, w2) on the device."""

    fwd: tuple
    bwd: tuple
    tile: int
    num_nodes: int


def build_blocked_spmm(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                       edge_weight: Optional[np.ndarray] = None, tile: int = 4096,
                       dst_buckets: int = 16, chunk_tiles: int = 512,
                       device="cuda") -> BlockedSpmm:
    """The window tilings of A and A^T, on ``device``: the card unless the
    caller asks for the CPU, as the trainers; asking for the card where
    there is none raises."""
    device = resolve_device(device)
    f = build_window_tiles(src, dst, num_nodes, edge_weight, tile, dst_buckets,
                           chunk_tiles)
    b = build_window_tiles(dst, src, num_nodes, edge_weight, tile, dst_buckets,
                           chunk_tiles)

    def dev(ts):
        return tuple(torch.as_tensor(a, device=device)
                     for a in chunk_tiles_host(ts, chunk_tiles))

    return BlockedSpmm(fwd=dev(f), bwd=dev(b), tile=tile, num_nodes=num_nodes)


class _ApplyBlockedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h: torch.Tensor, op: BlockedSpmm):
        ctx.op = op
        return spmm_sum_blocked_dev(h, *op.fwd, op.tile, op.num_nodes)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        op = ctx.op
        return spmm_sum_blocked_dev(g.contiguous(), *op.bwd, op.tile, op.num_nodes), None


def apply_blocked_spmm(h: torch.Tensor, op: BlockedSpmm) -> torch.Tensor:
    """A h through the forward tiling; its gradient A^T g through the
    transposed one (the reference's custom VJP)."""
    return _ApplyBlockedSpmm.apply(h, op)

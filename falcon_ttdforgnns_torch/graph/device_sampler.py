"""In-step neighbour sampling on the device (``--mode puregpu``).

Port of ``falcon_ttdforgnns_tpu/graph/device_sampler.py``.  The CSR arrays
(``indptr``, ``indices``, int32) or a prebuilt neighbour table live in
device memory, and each train step samples its fan-out tree there with a
few gathers and one draw of random bits per hop, so only the seeds and
labels cross from the host.  The JAX package does this in plain XLA, with
no Pallas kernel; the port does it in plain PyTorch tensor ops.  Nothing
here reads a value back to the host.

Sampling semantics are the host sampler's (``graph/sampler.py``): uniform
over in-neighbours with replacement, an isolated node samples itself.
``torch.Generator`` bits are not ``jax.random``'s, so the two packages
agree in distribution, not draw for draw; ``build_neighbor_table`` is host
numpy and equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _below(bound: torch.Tensor, fanout: int, generator: torch.Generator) -> torch.Tensor:
    """(M, fanout) int64 draws, uniform in [0, bound[m]) for each row m
    (bound >= 1, < 2^31): 32 random bits a slot, scaled as
    ``(bits * bound) >> 32``, which is within 2^-32 of uniform for every
    bound and never reaches it (``torch.randint`` takes no per-row bound,
    and ``rand * bound`` in float can round up to the bound)."""
    bits = torch.randint(0, 1 << 32, (bound.shape[0], fanout), dtype=torch.int64,
                         device=bound.device, generator=generator)
    return (bits * bound[:, None]) >> 32


def device_sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                            nodes: torch.Tensor, fanout: int,
                            generator: torch.Generator) -> torch.Tensor:
    """(M,) nodes -> (M, fanout) int32 uniform in-neighbours, with
    replacement; an isolated node samples itself.  The gather is clamped to
    the last edge, as in the JAX package; only the per-step offsets are
    int64, the graph stays int32."""
    nodes = nodes.reshape(-1).to(torch.int32)
    if indices.shape[0] == 0:  # edgeless graph: every node samples itself
        return nodes[:, None].expand(-1, fanout).contiguous()
    at = nodes.long()
    start = indptr[at].long()
    deg = indptr[at + 1].long() - start
    gather = torch.clamp(start[:, None] + _below(deg.clamp(min=1), fanout, generator),
                         max=indices.shape[0] - 1)
    return torch.where(deg[:, None] > 0, indices[gather], nodes[:, None])


def build_neighbor_table(indptr: np.ndarray, indices: np.ndarray,
                         width: int, seed: int = 0) -> np.ndarray:
    """Host-side (N, width) int32 table: slot j of node v is an iid uniform
    draw from v's in-neighbours (v itself when isolated), bit for bit the
    JAX package's table for the same seed.  Sampling a uniform slot at
    train time is then the CSR sampler's distribution for each draw; one
    run sees at most ``width`` distinct neighbours of a node."""
    n = indptr.shape[0] - 1
    if indices.shape[0] == 0:  # edgeless graph: all self-loops
        return np.repeat(np.arange(n, dtype=np.int32)[:, None], width, axis=1)
    rng = np.random.default_rng(seed)
    tbl = np.empty((n, width), np.int32)
    chunk = 8_000_000  # bounds the float64 draws at ~2 GB for 111M-node graphs
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        start = indptr[lo:hi].astype(np.int64)
        deg = indptr[lo + 1:hi + 1].astype(np.int64) - start
        offs = (rng.random((hi - lo, width))
                * np.maximum(deg, 1)[:, None]).astype(np.int64)
        rows = indices[np.minimum(start[:, None] + offs,
                                  max(indices.shape[0] - 1, 0))]
        isolated = deg == 0
        if isolated.any():
            rows[isolated] = np.arange(lo, hi, dtype=np.int64)[isolated, None]
        tbl[lo:hi] = rows
    return tbl


def device_sample_block(indptr: torch.Tensor, indices: torch.Tensor,
                        seeds: torch.Tensor, fanouts: Sequence[int],
                        generator: torch.Generator) -> List[torch.Tensor]:
    """The fan-out tree on the device: ``layers[l]`` of shape
    (B, prod(rev_fanouts[:l+1])) int32, the contract of the host
    ``sample_block``; ``fanouts`` is innermost first, like
    ``--fan-out 5,10,15``."""
    B = seeds.shape[0]
    frontier = seeds.to(torch.int32)
    layers: List[torch.Tensor] = []
    for f in reversed(list(fanouts)):
        frontier = device_sample_neighbors(indptr, indices, frontier, f, generator).reshape(B, -1)
        layers.append(frontier)
    return layers


def device_sample_block_table(table: torch.Tensor, seeds: torch.Tensor,
                              fanouts: Sequence[int],
                              generator: torch.Generator) -> List[torch.Tensor]:
    """``device_sample_block`` over a prebuilt (N, W) neighbour table (the
    same layer contract): each hop draws a uniform slot per sample and
    gathers that one table entry, no indptr or degree lookup.  The JAX
    package gathers the whole row and then the slot; on the card the
    entries of one row share its 4W-byte line, so gathering the entries
    alone reads the same lines."""
    width = table.shape[1]
    flat_table = table.reshape(-1)
    B = seeds.shape[0]
    frontier = seeds.to(torch.int32)
    layers: List[torch.Tensor] = []
    for f in reversed(list(fanouts)):
        rows = frontier.reshape(-1).long() * width
        cols = torch.randint(0, width, (rows.shape[0], f), device=table.device,
                             generator=generator)
        frontier = flat_table[rows[:, None] + cols].reshape(B, -1)
        layers.append(frontier)
    return layers

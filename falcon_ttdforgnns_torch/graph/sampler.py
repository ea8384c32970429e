"""Host-side neighbor sampling with static output shapes.

Port of the numpy path of ``falcon_ttdforgnns_tpu/graph/sampler.py``:
the dense recursive-fanout formulation

  layer 0 seeds:        (B,)
  layer 1 neighbors:    (B, f1)
  layer 2 neighbors:    (B, f1*f2)   ... etc.

Sampling is uniform with replacement over in-neighbors; isolated nodes
self-loop.  The threaded native sampler (``_native.py``) draws the blocks,
seeded from the generator exactly as the JAX package seeds its own native
sampler, so for the same generator seed the blocks equal the JAX
package's bit for bit.  The numpy path beside it is the JAX package's
numpy path; it runs only where ``_native`` is set to None (the tests
that hold it to JAX's).  The loader counts each id's accesses
(``NeighborLoader.freq``), the host-side frequencies of the hot-row cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from . import _native
from .csr import CSRGraph


@dataclass
class SampledBatch:
    """One training minibatch: seeds + per-layer dense neighbor tensors.
    ``layers[l]`` has shape (B, f_1*...*f_{l+1}) int32."""

    seeds: np.ndarray                 # (B,)
    layers: List[np.ndarray]          # level l: (B, prod(fanouts[:l+1]))
    labels: Optional[np.ndarray] = None

    @property
    def all_nodes(self) -> np.ndarray:
        return np.concatenate([self.seeds] + [l.reshape(-1) for l in self.layers])


def _sample_neighbors(graph: CSRGraph, nodes: np.ndarray, fanout: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(M,) nodes -> (M, fanout) sampled in-neighbors (with replacement;
    self-loop for isolated nodes)."""
    if _native is not None:
        return _native.sample_neighbors(graph.indptr, graph.indices, nodes, fanout,
                                        int(rng.integers(1, 2**31 - 1)))
    deg = graph.indptr[nodes + 1] - graph.indptr[nodes]          # (M,)
    offs = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(nodes), fanout))
    flat = graph.indices[np.minimum(graph.indptr[nodes][:, None] + offs,
                                    len(graph.indices) - 1)]
    return np.where(deg[:, None] > 0, flat, nodes[:, None]).astype(np.int32)


def sample_block(graph: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                 rng: np.random.Generator) -> SampledBatch:
    """Recursive fanout sampling.  ``fanouts`` is listed innermost-layer
    first like ``--fan-out 5,10,15``: the *last* fanout is used for the
    seeds' direct neighbors."""
    rev = list(reversed(list(fanouts)))
    if _native is not None:
        layers = _native.sample_block_multi(graph.indptr, graph.indices,
                                            seeds.astype(np.int64), rev,
                                            int(rng.integers(1, 2**63 - 1)))
        return SampledBatch(seeds=seeds.astype(np.int32), layers=layers)
    layers: List[np.ndarray] = []
    frontier = seeds.astype(np.int32)
    B = len(seeds)
    for f in rev:
        nbrs = _sample_neighbors(graph, frontier.reshape(-1), f, rng)
        frontier = nbrs.reshape(B, -1)
        layers.append(frontier)
    return SampledBatch(seeds=seeds.astype(np.int32), layers=layers)


class NeighborLoader:
    """Minibatch iterator: shuffled seed batches -> SampledBatch.  Every
    step sees exactly ``batch_size`` seeds (the final ragged batch wraps
    around the epoch order).  With ``num_workers > 1`` batches are sampled
    by a thread pool from per-batch child generators and yielded in order.
    With ``track_freq`` every yielded batch adds one to ``freq`` (int64,
    one per node) for each of its ids, duplicates included: the LFU counts
    of the hot-row cache, in the consuming thread."""

    def __init__(self, graph: CSRGraph, seed_nodes: np.ndarray, labels: np.ndarray,
                 fanouts: Sequence[int], batch_size: int, shuffle: bool = True,
                 seed: int = 0, track_freq: bool = True, num_workers: int = 1):
        self.graph = graph
        self.seed_nodes = np.asarray(seed_nodes, dtype=np.int64)
        self.labels = labels
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, int(num_workers))
        self.track_freq = track_freq
        self.freq = np.zeros(graph.num_nodes, dtype=np.int64) if track_freq else None

    def __len__(self) -> int:
        return max(1, len(self.seed_nodes) // self.batch_size)

    def _batch_seeds(self, order: np.ndarray, b: int) -> np.ndarray:
        pick = order[b * self.batch_size:(b + 1) * self.batch_size]
        if len(pick) < self.batch_size:
            pick = np.resize(np.concatenate([pick, order]), self.batch_size)
        return self.seed_nodes[pick]

    def _make_batch(self, seeds: np.ndarray, rng: np.random.Generator) -> SampledBatch:
        batch = sample_block(self.graph, seeds, self.fanouts, rng)
        batch.labels = self.labels[seeds].astype(np.int32)
        return batch

    def _count(self, batch: SampledBatch) -> SampledBatch:
        """Add the batch's accesses to ``freq``: the integers of the JAX
        loader's ``np.add.at``, by one ``np.bincount``."""
        if self.track_freq:
            self.freq += np.bincount(batch.all_nodes, minlength=len(self.freq))
        return batch

    def __iter__(self) -> Iterator[SampledBatch]:
        order = self.rng.permutation(len(self.seed_nodes)) if self.shuffle \
            else np.arange(len(self.seed_nodes))
        n_batches = len(self)
        if self.num_workers <= 1:
            for b in range(n_batches):
                yield self._count(self._make_batch(self._batch_seeds(order, b), self.rng))
            return
        import concurrent.futures as _cf
        from collections import deque
        child = self.rng.spawn(n_batches)
        with _cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque()
            depth = self.num_workers + 2
            b_next = 0
            while b_next < n_batches or pending:
                while b_next < n_batches and len(pending) < depth:
                    pending.append(pool.submit(
                        self._make_batch, self._batch_seeds(order, b_next),
                        child[b_next]))
                    b_next += 1
                yield self._count(pending.popleft().result())

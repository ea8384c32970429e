"""Graph-topology-aware node reordering (``--partition``).

Port of ``falcon_ttdforgnns_tpu/graph/reorder.py``, function for function:
for the same graph and seed every ordering gives the JAX package's
permutation.  FALCON's first contribution: relabel node ids so
topologically-close nodes get contiguous indices, aligning graph locality
with the TT index digit structure (`graphloader.py:277-454`, SURVEY.md
§0.1).  Partition flag semantics preserved from the reference
(`tt_utils.py:51`, `graphloader.py:411-446`):

  partition > 0   METIS-style k-way partition reorder
  partition == 0  random permutation
  partition == -1 recursive multi-level partition matched to TT p-shapes
  partition == -2 reverse Cuthill-McKee (RCMK)
  partition == -3 degree sort (the reference's ``custom_reordering``)
  partition == -4 Louvain communities then partition within clusters

The reference shells out to METIS via DGL; this framework implements a
self-contained multilevel partitioner (the native runtime's
``partition_kway``, ``csrc/falcon_native.cpp``; the numpy functions here
run only where ``_native`` is set to None, as in the tests that hold them
to the JAX package's): heavy-edge-matching coarsening + greedy BFS-grown
k-way split + boundary refinement.  All reorders are one-time host-side
preprocessing; results should be cached on disk for big graphs
(SURVEY.md §7 hard parts).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .csr import CSRGraph

from . import _native


# ---------------------------------------------------------------------------
# basic reorders
# ---------------------------------------------------------------------------

def random_permutation(graph: CSRGraph, seed: int = 0) -> np.ndarray:
    """partition == 0 (`graphloader.py:443-446`)."""
    return np.random.default_rng(seed).permutation(graph.num_nodes).astype(np.int64)


def degree_reorder(graph: CSRGraph, pct: float = 80.0) -> np.ndarray:
    """Degree-threshold reorder: nodes above the pct-th degree percentile
    first (hot nodes get small contiguous ids — they share TT prefixes and
    fill the cache), then the rest in original order
    (`graphloader.py:324-356` ``custom_reordering``)."""
    deg = graph.degrees
    thresh = np.percentile(deg, pct)
    hot = np.where(deg >= thresh)[0]
    cold = np.where(deg < thresh)[0]
    order = np.concatenate([hot, cold])
    perm = np.empty(graph.num_nodes, dtype=np.int64)
    perm[order] = np.arange(graph.num_nodes)
    return perm


def rcmk_reorder(graph: CSRGraph) -> np.ndarray:
    """Reverse Cuthill-McKee (partition == -2, `graphloader.py:430-433`)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = graph.num_nodes
    data = np.ones(graph.num_edges, dtype=np.int8)
    mat = sp.csr_matrix((data, graph.indices, graph.indptr), shape=(n, n))
    order = reverse_cuthill_mckee(mat, symmetric_mode=True)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


# ---------------------------------------------------------------------------
# multilevel k-way partitioning (METIS-style, self-contained)
# ---------------------------------------------------------------------------

def _heavy_edge_matching(graph: CSRGraph, rng: np.random.Generator) -> np.ndarray:
    """Greedy matching: visit nodes in random order, match with an unmatched
    neighbor (first unmatched = heaviest under unit weights).  Returns
    coarse id per node."""
    n = graph.num_nodes
    match = np.full(n, -1, dtype=np.int64)
    order = rng.permutation(n)
    indptr, indices = graph.indptr, graph.indices
    for u in order:
        if match[u] != -1:
            continue
        match[u] = u
        for v in indices[indptr[u]:indptr[u + 1]]:
            if match[v] == -1:
                match[u] = v
                match[v] = u
                break
    # assign coarse ids
    coarse = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for u in range(n):
        if coarse[u] == -1:
            coarse[u] = nxt
            if match[u] != u and match[u] != -1:
                coarse[match[u]] = nxt
            nxt += 1
    return coarse


def _coarsen(graph: CSRGraph, coarse: np.ndarray) -> CSRGraph:
    src, dst = graph.to_coo()
    cs, cd = coarse[src], coarse[dst]
    keep = cs != cd
    n_coarse = int(coarse.max()) + 1
    return CSRGraph.from_edges(cs[keep], cd[keep], n_coarse, add_reverse=False, dedup=True)


def _bfs_grow_partition(graph: CSRGraph, k: int, rng: np.random.Generator) -> np.ndarray:
    """Grow k balanced parts by multi-source BFS from random seeds."""
    n = graph.num_nodes
    part = np.full(n, -1, dtype=np.int32)
    target = -(-n // k)
    sizes = np.zeros(k, dtype=np.int64)
    indptr, indices = graph.indptr, graph.indices
    from collections import deque

    seeds = rng.choice(n, size=min(k, n), replace=False)
    queues = [deque([int(s)]) for s in seeds]
    for p, s in enumerate(seeds):
        part[s] = p
        sizes[p] = 1
    active = True
    while active:
        active = False
        for p in range(k):
            if sizes[p] >= target or not queues[p]:
                continue
            budget = 64  # round-robin growth keeps parts balanced
            while queues[p] and sizes[p] < target and budget > 0:
                u = queues[p].popleft()
                for v in indices[indptr[u]:indptr[u + 1]]:
                    if part[v] == -1:
                        part[v] = p
                        sizes[p] += 1
                        queues[p].append(int(v))
                        budget -= 1
                        if sizes[p] >= target or budget <= 0:
                            break
            if queues[p]:
                active = True
    # orphans (disconnected): round-robin to smallest parts
    orphans = np.where(part == -1)[0]
    for u in orphans:
        p = int(np.argmin(sizes))
        part[u] = p
        sizes[p] += 1
    return part


def partition_graph(graph: CSRGraph, k: int, seed: int = 0,
                    coarsen_to: int = 4096) -> np.ndarray:
    """METIS-style multilevel k-way partition: coarsen by heavy-edge matching
    until small, BFS-grow k parts, project back.  Returns part id per node.

    The native runtime's ``partition_kway`` (built at its first call; a
    failed build raises); the numpy path below is the JAX package's numpy
    path, fine up to a few million nodes.
    """
    if k <= 1:
        return np.zeros(graph.num_nodes, dtype=np.int32)
    if _native is not None:
        return _native.partition_kway(graph.indptr, graph.indices, k, seed)
    rng = np.random.default_rng(seed)
    # coarsening phase
    graphs = [graph]
    maps: List[np.ndarray] = []
    g = graph
    while g.num_nodes > max(coarsen_to, 4 * k) and len(maps) < 20:
        coarse = _heavy_edge_matching(g, rng)
        if coarse.max() + 1 >= g.num_nodes * 0.95:  # matching stalled
            break
        g = _coarsen(g, coarse)
        graphs.append(g)
        maps.append(coarse)
    # initial partition on coarsest graph
    part = _bfs_grow_partition(g, k, rng)
    # project back (uncoarsening; refinement omitted in fallback)
    for coarse in reversed(maps):
        part = part[coarse]
    return part


def partition_reorder(graph: CSRGraph, k: int, seed: int = 0) -> np.ndarray:
    """partition > 0: relabel so each part's nodes are contiguous
    (`graphloader.py:439-441` ``dgl.reorder_graph(..., 'metis')``)."""
    part = partition_graph(graph, k, seed)
    order = np.argsort(part, kind="stable")
    perm = np.empty(graph.num_nodes, dtype=np.int64)
    perm[order] = np.arange(graph.num_nodes)
    return perm


def recursive_partition_reorder(graph: CSRGraph, levels: Sequence[int],
                                seed: int = 0) -> np.ndarray:
    """partition == -1: multi-level recursive partition matched to the TT
    p-shapes (`graphloader.py:358-372` ``recursive_metis_reorder`` with
    levels like [125, 140, 140]): partition into levels[0] parts, then each
    part into levels[1], ... so that the TT digits of co-located nodes
    coincide at every level."""
    n = graph.num_nodes
    # composite key per node across levels, built depth-first
    key = np.zeros(n, dtype=np.int64)
    segments = [np.arange(n)]
    src, dst = graph.to_coo()
    for li, k in enumerate(levels):
        if k <= 1:
            continue
        new_segments = []
        for seg in segments:
            if len(seg) <= 1:
                # still scale (part 0): composite keys must stay comparable
                # across segments or the singleton lands in the wrong block
                key[seg] = key[seg] * k
                new_segments.append(seg)
                continue
            sub = _induced_subgraph(graph, seg, src, dst)
            part = partition_graph(sub, min(k, len(seg)), seed + li)
            key[seg] = key[seg] * k + part
            for p in range(min(k, len(seg))):
                new_segments.append(seg[part == p])
        segments = new_segments
        if len(segments) > 4096:  # deeper splits: stop inducing, key is enough
            break
    order = np.argsort(key, kind="stable")
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


def _induced_subgraph(graph: CSRGraph, nodes: np.ndarray,
                      src: np.ndarray, dst: np.ndarray) -> CSRGraph:
    mask = np.zeros(graph.num_nodes, dtype=bool)
    mask[nodes] = True
    local = np.full(graph.num_nodes, -1, dtype=np.int64)
    local[nodes] = np.arange(len(nodes))
    keep = mask[src] & mask[dst]
    return CSRGraph.from_edges(local[src[keep]], local[dst[keep]], len(nodes), add_reverse=False)


def louvain_partition_reorder(graph: CSRGraph, min_cluster: int = 100,
                              k_within: int = 8, seed: int = 0) -> np.ndarray:
    """partition == -4: community detection, then partition within clusters
    larger than ``min_cluster`` (`graphloader.py:277-322`
    ``louvain_and_metis_reorder``).  Uses label propagation (networkx-free,
    scales better than python-louvain) as the community stage."""
    comm = _label_propagation(graph, seed=seed)
    n = graph.num_nodes
    key = comm.astype(np.int64) * (k_within + 1)
    src, dst = graph.to_coo()
    for c in np.unique(comm):
        seg = np.where(comm == c)[0]
        if len(seg) > min_cluster:
            sub = _induced_subgraph(graph, seg, src, dst)
            part = partition_graph(sub, k_within, seed)
            key[seg] += part
    order = np.argsort(key, kind="stable")
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


def _label_propagation(graph: CSRGraph, iters: int = 5, seed: int = 0) -> np.ndarray:
    """Simple async label propagation for community detection."""
    n = graph.num_nodes
    labels = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    indptr, indices = graph.indptr, graph.indices
    for _ in range(iters):
        order = rng.permutation(n)
        for u in order:
            nbrs = indices[indptr[u]:indptr[u + 1]]
            if len(nbrs) == 0:
                continue
            vals, counts = np.unique(labels[nbrs], return_counts=True)
            labels[u] = vals[np.argmax(counts)]
    # compact label space
    _, labels = np.unique(labels, return_inverse=True)
    return labels


# ---------------------------------------------------------------------------
# dispatch (flag parity with the reference)
# ---------------------------------------------------------------------------

def reorder_permutation(graph: CSRGraph, partition: int,
                        levels: Optional[Sequence[int]] = None,
                        seed: int = 0) -> Optional[np.ndarray]:
    """Dispatch on the reference's ``--partition`` flag semantics
    (`graphloader.py:399-454` ``dgl_partition``). Returns a permutation
    (new id per old node) or None for no-op."""
    if partition > 0:
        return partition_reorder(graph, partition, seed)
    if partition == 0:
        return random_permutation(graph, seed)
    if partition == -1:
        return recursive_partition_reorder(graph, levels or [50, 60, 60], seed)
    if partition == -2:
        return rcmk_reorder(graph)
    if partition == -3:
        return degree_reorder(graph)
    if partition == -4:
        return louvain_partition_reorder(graph, seed=seed)
    return None


#: In-process memo over the disk cache: the autotuner re-reorders the same
#: graph every trial, and at products scale each trial would otherwise
#: re-load a 2.45M-entry permutation from disk.
_PERM_MEMO = None


def reorder_permutation_cached(graph: CSRGraph, partition: int,
                               cache_dir: str = "./reorder_cache",
                               levels: Optional[Sequence[int]] = None,
                               seed: int = 0) -> Optional[np.ndarray]:
    """Disk-cached reorder (SURVEY.md §7: partitioning papers100M is a
    multi-hour job — cache the permutation keyed on graph shape + flags)."""
    import hashlib
    import os

    global _PERM_MEMO
    if _PERM_MEMO is None:
        from ..utils.host_cache import LRUCache

        _PERM_MEMO = LRUCache(8)

    if partition == 0:
        return reorder_permutation(graph, partition, levels, seed)
    key = hashlib.sha1(
        f"{graph.num_nodes}:{graph.num_edges}:{partition}:{levels}:{seed}"
        .encode() + graph.indptr[:1024].tobytes()).hexdigest()[:16]
    memoized = _PERM_MEMO.get(key)
    if memoized is not None:
        return memoized
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"perm_{key}.npy")
    if os.path.exists(path):
        perm = np.load(path)
        _PERM_MEMO.put(key, perm)
        return perm
    perm = reorder_permutation(graph, partition, levels, seed)
    if perm is not None:
        np.save(path, perm)
        _PERM_MEMO.put(key, perm)
    return perm

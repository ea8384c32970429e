"""The benchmark's graphs: a numpy copy of the port's planted-partition
generator (``hard_synthetic_dataset`` with an in-neighbour CSR whose rows
are sorted, as the port's native builder leaves them), and any generator
that a file ``gnnbench/graphs/<name>.py`` brings, kept on disk in
``gnnbench/cache/`` once per checkout.

A configuration's graph is data, not the seed's: it is drawn at its own
dataset seed, so every run of every cell sees the same graph.  The
arrays equal those of ``falcon_ttdforgnns_torch.graph.get_dataset(name,
official_split=True)`` (``tests/test_gnnbench_graph.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

GRAPH_FILES = ("indptr", "indices", "labels", "train_idx", "val_idx", "test_idx")


@dataclass
class Graph:
    """An in-neighbour CSR (row v lists the sources of v's in-edges,
    ascending) with node labels and the three splits."""

    indptr: np.ndarray     # (N + 1,) int64
    indices: np.ndarray    # (E,) int32
    labels: np.ndarray     # (N,) int32
    train_idx: np.ndarray  # int64, ascending
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    feat_dim: int

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def planted_partition(num_nodes: int, avg_degree: int, num_classes: int, feat_dim: int,
                      seed: int, homophily: float,
                      split_counts: Optional[Sequence[int]]) -> Graph:
    """Communities drawn uniformly over the ids; each of N * avg_degree
    drawn edges joins its source to a node of the same community with
    probability ``homophily`` and to a uniform node otherwise; self-loops
    dropped, every edge also reversed; the splits a random permutation's
    leading ``split_counts`` (60/20/20 without them)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    order = np.argsort(comm, kind="stable")
    counts = np.bincount(comm, minlength=num_classes)
    starts = np.zeros(num_classes, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    E = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, E)
    csrc = comm[src]
    off = rng.integers(0, 1 << 62, E) % np.maximum(counts[csrc], 1)
    dst_intra = order[starts[csrc] + off]
    del csrc, off
    dst_rand = rng.integers(0, num_nodes, E)
    intra = rng.random(E) < homophily
    dst = np.where(intra, dst_intra, dst_rand)
    del dst_intra, dst_rand, intra
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # both directions; one sort of (row, source) keys gives the rows and
    # each row's sources ascending
    key = np.concatenate([dst * num_nodes + src, src * num_nodes + dst])
    del src, dst, keep
    key.sort()
    rows = key // num_nodes
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_nodes), out=indptr[1:])
    del rows
    indices = (key % num_nodes).astype(np.int32)
    del key
    perm = rng.permutation(num_nodes)
    if split_counts is not None:
        n_train, n_val, n_test = split_counts
        if n_train + n_val + n_test > num_nodes:
            raise ValueError("split_counts exceed num_nodes")
        perm = perm[: n_train + n_val + n_test]
    else:
        n_train, n_val = int(0.6 * num_nodes), int(0.2 * num_nodes)
    return Graph(indptr=indptr, indices=indices, labels=comm,
                 train_idx=np.sort(perm[:n_train]).astype(np.int64),
                 val_idx=np.sort(perm[n_train:n_train + n_val]).astype(np.int64),
                 test_idx=np.sort(perm[n_train + n_val:]).astype(np.int64),
                 num_classes=num_classes, feat_dim=feat_dim)


GENERATORS = {"planted_partition": planted_partition}
GRAPHS = Path(__file__).resolve().parent / "graphs"  # generators found by file
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def generator(name: str):
    """The generator a configuration's ``graph.generator`` names: a built-in
    one, or the ``generate`` of ``graphs/<name>.py`` beside this file."""
    if name in GENERATORS:
        return GENERATORS[name]
    path = GRAPHS / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"no graph generator {name!r}: neither built in "
                         f"({sorted(GENERATORS)}) nor a file {path}")
    from .harness import _load_module  # loads it as the harness loads a reader
    return _load_module(path).generate


def _cache_name(spec: dict) -> str:
    """The built-in generator's names as they were; any other generator's
    directory is named from a hash of its whole spec, so that two specs
    never share one."""
    if spec["generator"] in GENERATORS:
        return (f"{spec['generator']}-n{spec['num_nodes']}-d{spec['avg_degree']}"
                f"-c{spec['num_classes']}-s{spec['seed']}")
    digest = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    return f"{spec['generator']}-{digest}"


def load_graph(spec: dict, cache_dir: Path) -> Graph:
    """The graph of a configuration's ``graph`` entry: read from
    ``cache_dir`` when this checkout has made it, else generated and
    written there (into a directory of its own, moved into place whole)."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    where = cache_dir / _cache_name(spec)
    meta_path = where / "meta.json"
    if meta_path.exists() and json.loads(meta_path.read_text()) == spec:
        arrays = {k: np.load(where / f"{k}.npy") for k in GRAPH_FILES}
        return Graph(**arrays, num_classes=spec["num_classes"], feat_dim=spec["feat_dim"])
    g = generator(spec["generator"])(**args)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = cache_dir / f".{where.name}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    for k in GRAPH_FILES:
        np.save(tmp / f"{k}.npy", getattr(g, k))
    (tmp / "meta.json").write_text(json.dumps(spec))
    if where.exists():
        import shutil
        shutil.rmtree(where)
    os.replace(tmp, where)
    return g


def edge_keys(g: Graph) -> np.ndarray:
    """Every edge as row * N + source, ascending (the CSR's order)."""
    n = g.num_nodes
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    return rows * n + g.indices.astype(np.int64)

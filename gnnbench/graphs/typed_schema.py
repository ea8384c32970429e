"""A heterogeneous graph from its schema: node types, relations between
them and their sizes, such as MAG240M's papers, authors and institutions
(``graphs/mag240m.json``).  It is the in-neighbour CSR of
``gnnbench.graph.Graph``: int64 ``indptr``, int32 ``indices``, each row's
sources ascending.

The spec, a configuration's ``graph`` block (``"generator":
"typed_schema"``):

* ``node_types``: ``[{"name", "count", "tail"}]``.  Each type's ids are one
  contiguous range, in the order listed.  ``tail`` is the tail index of the
  Pareto propensity its nodes are drawn by (2.0 where left out).
* ``relations``: ``[{"name", "src", "dst", "edges", "reverse",
  "homophily"}]``: ``edges`` distinct pairs of a ``src`` node and a ``dst``
  node, each an in-edge of its ``dst`` row, and with ``reverse`` also of its
  ``src`` row.  A relation between nodes of one type with ``reverse`` is
  undirected: a pair and its reverse are one pair.  With probability
  ``homophily`` (0 where left out) a pair's ``dst`` lies in its ``src``
  node's community.  A relation is a function of its endpoints' types, so
  no array per edge is kept: :func:`relation_of` works it out.
* ``labelled``: the type whose nodes carry labels (their community) and
  the splits; every other node's label is -1.
* ``num_classes`` (the communities), ``feat_dim``, ``seed``,
  ``split_counts`` (train, valid, test among the labelled type; 60/20/20
  without them) and ``scale``, which multiplies every count, nodes, edges
  and splits, with at least one node per type.

How it is drawn: every node has a community, uniform over the classes,
and a propensity ``1 + Pareto(tail)``; a node is drawn in proportion to its
propensity (from 2 tickets per unit, rounded).  A pair's ``src`` is drawn
from all nodes of its type; its ``dst`` from the ``src`` node's community
with probability ``homophily``, else from all nodes of its type.
Self-loops and duplicate pairs are redrawn until the relation has its
``edges`` distinct pairs, so every relation has its count exactly.

Memory: the relations are drawn one at a time, twice.  The first time
counts each row's in-edges by relation, which gives ``indptr``; the
second, from the same seeds, places each relation's edges at their rows'
offsets, so that the peak is the output and one relation's draws, never
every edge's key at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gnnbench.graph import Graph

CHUNK = 1 << 22      # pairs drawn, counted or placed at a time
TICKETS = 2          # tickets a unit of propensity; the least node holds 2
MAX_ROUNDS = 64      # rounds of redraws before a relation is refused
DEFAULT_TAIL = 2.0


# --------------------------------------------------------------- the schema
def type_counts(spec: dict) -> List[int]:
    """Each node type's count at the spec's ``scale``."""
    scale = spec.get("scale", 1.0)
    return [max(1, round(t["count"] * scale)) for t in spec["node_types"]]


def type_starts(spec: dict) -> List[int]:
    """The first id of each node type, and the number of nodes last."""
    return [0, *np.cumsum(type_counts(spec)).tolist()]


def relation_list(spec: dict) -> List[Tuple[str, int, int]]:
    """(name, source type, destination type) of each relation an edge can
    have, by its id: each relation, followed by its reverse
    (``<name>.rev``) where that joins two types.  Refuses a spec in which
    one ordered pair of types has two relations."""
    index = {t["name"]: k for k, t in enumerate(spec["node_types"])}
    out, seen = [], set()
    for r in spec["relations"]:
        a, b = index[r["src"]], index[r["dst"]]
        pairs = [(r["name"], a, b)]
        if r.get("reverse", False) and a != b:
            pairs.append((r["name"] + ".rev", b, a))
        for p in pairs:
            if p[1:] in seen:
                raise ValueError(f"two relations join {r['src']} and {r['dst']} the same way")
            seen.add(p[1:])
        out += pairs
    return out


def node_type_of(spec: dict, ids):
    """The node type of each id (numpy arrays or torch tensors alike)."""
    out = ids * 0
    for b in type_starts(spec)[1:-1]:
        out = out + (ids >= b)
    return out


def relation_of(spec: dict, src, dst):
    """The relation id (:func:`relation_list`) of each edge ``src -> dst``
    (a row ``dst`` of the CSR listing ``src``), -1 where the schema has
    none."""
    T = len(spec["node_types"])
    code = node_type_of(spec, src) * T + node_type_of(spec, dst)
    out = code * 0 - 1
    for rid, (_, a, b) in enumerate(relation_list(spec)):
        out = out + (code == a * T + b) * (rid + 1)
    return out


# ---------------------------------------------------------------- the draws
@dataclass
class _Type:
    start: int
    count: int
    comm: np.ndarray      # (count,) int32, each node's community
    tickets: np.ndarray   # int32 local ids, grouped by community
    cstart: np.ndarray    # (classes,) int64, each community's first ticket
    clen: np.ndarray      # (classes,) int64, each community's tickets


def _node_type(t: dict, k: int, start: int, count: int, num_classes: int, seed: int) -> _Type:
    rng = np.random.default_rng([seed, 0, k])
    comm = rng.integers(0, num_classes, count).astype(np.int32)
    weight = 1.0 + rng.pareto(t.get("tail", DEFAULT_TAIL), count)
    tix = np.rint(TICKETS * weight).astype(np.int64)
    del weight
    if tix.sum() > 64 * TICKETS * count:
        raise ValueError(f"the tail index of {t['name']} is too heavy: "
                         f"{tix.sum()} tickets for {count} nodes")
    order = np.argsort(comm, kind="stable")
    tickets = np.repeat(order.astype(np.int32), tix[order])
    del order
    clen = np.bincount(comm, weights=tix, minlength=num_classes).astype(np.int64)
    cstart = np.zeros(num_classes, dtype=np.int64)
    np.cumsum(clen[:-1], out=cstart[1:])
    return _Type(start=start, count=count, comm=comm, tickets=tickets, cstart=cstart, clen=clen)


@dataclass
class _Relation:
    index: int
    src: int              # node type of the pairs' first end
    dst: int
    edges: int
    reverse: bool
    homophily: float

    @property
    def undirected(self) -> bool:
        return self.reverse and self.src == self.dst


def _draw_keys(rel: _Relation, a: _Type, b: _Type, m: int, rng) -> np.ndarray:
    """m pairs drawn, as keys ``first * b.count + second`` of local ids (the
    lower id first in an undirected relation), self-loops left out."""
    s = a.tickets[rng.integers(0, a.tickets.size, m)]
    d = b.tickets[rng.integers(0, b.tickets.size, m)]
    if rel.homophily > 0:
        intra = np.flatnonzero(rng.random(m) < rel.homophily)
        c = a.comm[s[intra]]
        size = b.clen[c]
        has = size > 0
        intra, c, size = intra[has], c[has], size[has]
        off = (rng.random(intra.size) * size).astype(np.int64)
        d[intra] = b.tickets[b.cstart[c] + off]
    if rel.undirected:
        s, d = np.minimum(s, d), np.maximum(s, d)
    if rel.src == rel.dst:
        keep = s != d
        s, d = s[keep], d[keep]
    return s.astype(np.int64) * b.count + d


def _unique_sorted_in_place(keys: np.ndarray) -> int:
    """Move the distinct values of the sorted ``keys`` to its front, in
    order, chunk by chunk; returns how many there are."""
    n = keys.size
    if n == 0:
        return 0
    w = 1
    for lo in range(1, n, CHUNK):
        hi = min(lo + CHUNK, n)
        vals = keys[lo:hi][keys[lo:hi] != keys[lo - 1:hi - 1]]
        keys[w:w + vals.size] = vals
        w += vals.size
    return w


def _relation_keys(rel: _Relation, a: _Type, b: _Type, seed: int) -> np.ndarray:
    """The relation's ``edges`` distinct pairs as sorted keys, drawn from
    its own seed (the same every time), duplicates and self-loops redrawn."""
    rng = np.random.default_rng([seed, 1, rel.index])
    keys = np.empty(rel.edges, dtype=np.int64)
    have = 0
    for _ in range(MAX_ROUNDS):
        need = rel.edges - have
        if need == 0:
            return keys
        w = have
        for lo in range(0, need, CHUNK):
            k = _draw_keys(rel, a, b, min(CHUNK, need - lo), rng)
            keys[w:w + k.size] = k
            w += k.size
        if have == 0:
            keys[:w].sort()
        else:  # two sorted runs: the stable sort merges them
            keys[have:w].sort()
            keys[:w].sort(kind="stable")
        have = _unique_sorted_in_place(keys[:w])
    raise ValueError(f"relation {rel.index} found {have} of its {rel.edges} distinct pairs "
                     f"in {MAX_ROUNDS} rounds")


def _swap_keys(keys: np.ndarray, n_first: int, n_second: int) -> None:
    """Rewrite keys ``x * n_second + y`` as ``y * n_first + x`` and sort them."""
    for lo in range(0, keys.size, CHUNK):
        x, y = np.divmod(keys[lo:lo + CHUNK], n_second)
        keys[lo:lo + CHUNK] = y * n_first + x
    keys.sort()


# ------------------------------------------------------------- the layout
# A direction is how a relation's pairs become in-edges: "rev" makes the
# first end the row (keys sorted as drawn), "fwd" the second (keys swapped).
# A row lists its sources by type in id order, and in an undirected
# relation its lower neighbours (fwd) before its higher ones (rev).
def _directions(rels: Sequence[_Relation]) -> List[Tuple[int, str, int, int]]:
    """(relation, kind, row type, source type), in each row's order."""
    out = []
    for r in rels:
        out.append((r.index, "fwd", r.dst, r.src))
        if r.reverse:
            out.append((r.index, "rev", r.src, r.dst))
    return sorted(out, key=lambda d: (d[2], d[3], d[1] != "fwd"))


def generate(node_types: List[dict], relations: List[dict], labelled: str, num_classes: int,
             feat_dim: int, seed: int, split_counts: Optional[Sequence[int]] = None,
             scale: float = 1.0) -> Graph:
    spec = {"node_types": node_types, "relations": relations, "scale": scale}
    relation_list(spec)  # one relation an ordered pair of types
    counts, starts = type_counts(spec), type_starts(spec)
    index = {t["name"]: k for k, t in enumerate(node_types)}
    types = [_node_type(t, k, starts[k], counts[k], num_classes, seed)
             for k, t in enumerate(node_types)]
    rels = []
    for i, r in enumerate(relations):
        rel = _Relation(index=i, src=index[r["src"]], dst=index[r["dst"]],
                        edges=round(r["edges"] * scale), reverse=bool(r.get("reverse", False)),
                        homophily=float(r.get("homophily", 0.0)))
        na, nb = counts[rel.src], counts[rel.dst]
        possible = na * (na - 1) // (2 if rel.undirected else 1) if rel.src == rel.dst else na * nb
        if rel.edges > possible // 2:
            raise ValueError(f"relation {r['name']}: {rel.edges} pairs among {possible} possible")
        rels.append(rel)
    dirs = _directions(rels)

    # first pass: each row's in-edges by direction
    per_dir: Dict[Tuple[int, str], np.ndarray] = {
        (ri, kind): np.zeros(counts[row], dtype=np.int64) for ri, kind, row, _ in dirs}
    for rel in rels:
        keys = _relation_keys(rel, types[rel.src], types[rel.dst], seed)
        for kind in ("rev", "fwd") if rel.reverse else ("fwd",):
            acc = per_dir[(rel.index, kind)]
            for lo in range(0, keys.size, CHUNK):
                rows = (keys[lo:lo + CHUNK] // types[rel.dst].count if kind == "rev"
                        else keys[lo:lo + CHUNK] % types[rel.dst].count)
                first = int(rows.min())
                got = np.bincount(rows - first)
                acc[first:first + got.size] += got
        del keys
    deg = np.zeros(starts[-1], dtype=np.int64)
    for ri, kind, row, _ in dirs:
        deg[starts[row]:starts[row + 1]] += per_dir[(ri, kind)]
    indptr = np.zeros(starts[-1] + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    del deg

    # each direction's offset: a row's start, its earlier directions' edges,
    # less the direction's own edges in earlier rows
    delta: Dict[Tuple[int, str], np.ndarray] = {}
    before = {row: indptr[starts[row]:starts[row + 1]].copy() for row in range(len(types))}
    for ri, kind, row, _ in dirs:
        c = per_dir.pop((ri, kind))
        cum = np.cumsum(c)
        cum -= c
        delta[(ri, kind)] = before[row] - cum
        before[row] += c
        del c, cum
    del before

    # second pass: the same draws, placed
    indices = np.empty(int(indptr[-1]), dtype=np.int32)
    for rel in rels:
        keys = _relation_keys(rel, types[rel.src], types[rel.dst], seed)
        for kind in ("rev", "fwd") if rel.reverse else ("fwd",):
            if kind == "fwd":
                _swap_keys(keys, types[rel.src].count, types[rel.dst].count)
            # rev keys as drawn (row = the first end), fwd keys swapped
            src_t = rel.dst if kind == "rev" else rel.src
            d = delta.pop((rel.index, kind))
            for lo in range(0, keys.size, CHUNK):
                chunk = keys[lo:lo + CHUNK]
                rows, srcs = np.divmod(chunk, types[src_t].count)
                pos = d[rows] + np.arange(lo, lo + chunk.size)
                indices[pos] = srcs + starts[src_t]
            del d
        del keys

    lab = types[index[labelled]]
    labels = np.full(starts[-1], -1, dtype=np.int32)
    labels[lab.start:lab.start + lab.count] = lab.comm
    perm = np.random.default_rng([seed, 2]).permutation(lab.count)
    if split_counts is not None:
        n_train, n_val, n_test = (round(c * scale) for c in split_counts)
        if n_train + n_val + n_test > lab.count:
            raise ValueError(f"split_counts exceed the {lab.count} {labelled} nodes")
        perm = perm[:n_train + n_val + n_test]
    else:
        n_train, n_val = int(0.6 * lab.count), int(0.2 * lab.count)
    perm += lab.start
    return Graph(indptr=indptr, indices=indices, labels=labels,
                 train_idx=np.sort(perm[:n_train]).astype(np.int64),
                 val_idx=np.sort(perm[n_train:n_train + n_val]).astype(np.int64),
                 test_idx=np.sort(perm[n_train + n_val:]).astype(np.int64),
                 num_classes=num_classes, feat_dim=feat_dim)

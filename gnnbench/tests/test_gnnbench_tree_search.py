"""The train check's row search (``check.tree_faults``, ``check.in_rows``)
counts what the search of a sorted array of every edge's key counted
before it: on a products-shaped graph and on a typed one with hubs and
isolated nodes, with faults planted in sampled steps, and through the
harness on each fault and control of the tiny train cells."""

import numpy as np
import pytest
import torch

from gnnbench import check, harness
from gnnbench.faults import FAULTS
from gnnbench.graph import edge_keys, planted_partition
from gnnbench.tests.cells import make_root
from gnnbench.tests.test_gnnbench_typed_schema import build, mag240m

FANOUTS = [5, 10, 15]
B = 64


def tree_faults_by_keys(edge_keys, deg, num_nodes, fanouts, steps, train_mask, labels):
    """The search this replaces, as it was: every edge's key row * N +
    source, sorted, searched for each (parent, child)."""
    bad = 0
    seen = torch.cat([st["seeds"].long() for st in steps])
    bad += int(seen.numel() - torch.unique(seen).numel())
    bad += int((~train_mask[seen]).sum())
    for st in steps:
        seeds = st["seeds"].long()
        B = seeds.shape[0]
        bad += int((st["labels"].long() != labels[seeds]).sum())
        parent = seeds.reshape(B, 1)
        for f, layer in zip(reversed(list(fanouts)), st["layers"]):
            child = layer.long().reshape(B, -1)
            if child.shape[1] != parent.shape[1] * f:
                return bad + 1
            par = parent.repeat_interleave(f, dim=1)
            iso = deg[par] == 0
            key = par * num_nodes + child
            at = torch.searchsorted(edge_keys, key.reshape(-1)).clamp(max=edge_keys.numel() - 1)
            hit = (edge_keys[at] == key.reshape(-1)).reshape(key.shape)
            bad += int((~torch.where(iso, child == par, hit)).sum())
            parent = child
    return bad


def products_shaped():
    return planted_partition(num_nodes=20000, avg_degree=25, num_classes=47, feat_dim=100,
                             seed=0, homophily=0.8, split_counts=[2000, 1000, 5000])


def typed():
    return build(mag240m(scale=2e-4))


def sample(g, rng, steps=3):
    """Steps as the recorder keeps them: distinct train seeds, each level's
    children drawn from their parents' in-neighbours (an isolated parent
    samples itself), levels widest last."""
    seeds = rng.permutation(g.train_idx)[:steps * B].reshape(steps, B)
    out = []
    for s in seeds:
        layers, parent = [], s.reshape(B, 1)
        for f in reversed(FANOUTS):
            par = np.repeat(parent, f, axis=1)
            lo, deg = g.indptr[par], np.diff(g.indptr)[par]
            pick = lo + (rng.random(par.shape) * np.maximum(deg, 1)).astype(np.int64)
            child = np.where(deg > 0, g.indices[np.minimum(pick, g.num_edges - 1)], par)
            layers.append(torch.as_tensor(child.reshape(-1), dtype=torch.int32))
            parent = child
        out.append({"seeds": torch.as_tensor(s, dtype=torch.int32),
                    "labels": torch.as_tensor(g.labels[s]), "layers": layers})
    return out


def plant(g, steps, fault, rng):
    st = steps[1]
    if fault == "stranger":  # children that are no in-neighbour of their parent
        for layer in st["layers"]:
            at = rng.choice(layer.numel(), 7, replace=False)
            layer[at] = torch.as_tensor(rng.integers(0, g.num_nodes, 7), dtype=torch.int32)
    elif fault == "isolated":  # an isolated parent that samples another node
        deg = np.diff(g.indptr)
        lonely = np.flatnonzero(deg == 0)
        seeds = st["seeds"].numpy()
        parents = np.repeat(seeds, FANOUTS[-1])
        layer = st["layers"][0]
        layer[:] = torch.as_tensor(parents, dtype=torch.int32)
        if lonely.size:
            layer[3] = int(lonely[0])
            st["layers"][1][FANOUTS[-2] * 3:FANOUTS[-2] * 4] = int(lonely[0]) + 1
    elif fault == "label":
        st["labels"][:5] = (st["labels"][:5] + 1) % g.num_classes
    elif fault == "repeat":
        steps[2]["seeds"][0] = st["seeds"][0]
    elif fault == "outside":
        st["seeds"][1] = int(g.test_idx[0])
    elif fault == "width":
        st["layers"][1] = st["layers"][1][:-B]
    return steps


@pytest.mark.parametrize("fault", ["none", "stranger", "isolated", "label", "repeat",
                                   "outside", "width"])
@pytest.mark.parametrize("make", [products_shaped, typed])
def test_row_search_counts_what_the_key_search_counted(make, fault):
    g = make()
    rng = np.random.default_rng(11)
    steps = plant(g, sample(g, rng), fault, rng)
    train_mask = torch.zeros(g.num_nodes, dtype=torch.bool)
    train_mask[torch.as_tensor(g.train_idx)] = True
    labels = torch.as_tensor(g.labels)
    indptr, indices = torch.as_tensor(g.indptr), torch.as_tensor(g.indices)
    new = check.tree_faults(indptr, indices, FANOUTS, steps, train_mask, labels)
    old = tree_faults_by_keys(torch.as_tensor(edge_keys(g)), torch.as_tensor(np.diff(g.indptr)),
                              g.num_nodes, FANOUTS, steps, train_mask, labels)
    assert new == old
    assert (new == 0) == (fault == "none"), new


def test_in_rows_against_each_rows_set():
    g = typed()
    deg = np.diff(g.indptr)
    rng = np.random.default_rng(5)
    hubs = np.argsort(deg)[-20:]
    rows = np.concatenate([hubs, np.flatnonzero(deg == 0)[:20], rng.integers(0, g.num_nodes, 400)])
    rows = np.repeat(rows, 6)
    vals = np.empty(rows.size, dtype=np.int64)
    for i, r in enumerate(rows):
        src = g.indices[g.indptr[r]:g.indptr[r + 1]]
        choice = i % 6
        if src.size and choice < 3:  # the first, the last, one between
            vals[i] = src[[0, -1, src.size // 2][choice]]
        else:  # below, above, or anywhere
            vals[i] = [-1, g.num_nodes, rng.integers(0, g.num_nodes)][choice % 3]
    got = check.in_rows(torch.as_tensor(g.indptr), torch.as_tensor(g.indices),
                        torch.as_tensor(rows), torch.as_tensor(vals))
    want = [v in set(g.indices[g.indptr[r]:g.indptr[r + 1]].tolist()) for r, v in zip(rows, vals)]
    assert got.tolist() == want
    assert deg[hubs].max() >= 500 and any(want) and not all(want)


@pytest.mark.parametrize("workload,control", [("sage-dense-tiny.train", "tf32"),
                                              ("sage-tt-tiny.train", "fp8")])
def test_faults_and_controls_read_the_same_count(tmp_path, monkeypatch, workload, control):
    """Every run of the harness's faults and its control counts with both
    searches, and they agree."""
    counts = []

    def both(indptr, indices, fanouts, steps, train_mask, labels):
        g = harness.Graph(indptr=indptr.numpy(), indices=indices.numpy(), labels=None,
                          train_idx=None, val_idx=None, test_idx=None, num_classes=0, feat_dim=0)
        old = tree_faults_by_keys(torch.as_tensor(edge_keys(g)), indptr[1:] - indptr[:-1],
                                  g.num_nodes, fanouts, steps, train_mask, labels)
        new = check_tree_faults(indptr, indices, fanouts, steps, train_mask, labels)
        counts.append((old, new))
        return new

    check_tree_faults = check.tree_faults
    monkeypatch.setattr(check, "tree_faults", both)
    root = make_root(tmp_path)
    for kw in [{}, {"control": control}, *({"fault": f} for f in FAULTS)]:
        harness.run_cell(root, workload, 9, 0.0, False, device="cpu", **kw)
    assert len(counts) == 2 + len(FAULTS)
    assert all(old == new for old, new in counts), counts

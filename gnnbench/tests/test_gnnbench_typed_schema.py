"""The ``typed_schema`` generator at MAG240M's published counts
(``graphs/mag240m.json``) cut to a thousandth: 244,161 nodes, 3,456,730
directed edges.  Only the schema's type pairs appear, every relation has
its scaled count and its reverse, the rows are sorted, the same seed gives
the same arrays, the cache round-trips under a name of its own, labels and
splits lie on papers alone, and papers' in-degrees are heavy-tailed."""

import json

import numpy as np
import pytest

from gnnbench import graph
from gnnbench.graphs import typed_schema as ts
from gnnbench.tests.cells import REPO

# OGB-LSC MAG240M (Hu et al., 2021; ogb.stanford.edu/docs/lsc/mag240m)
PUBLISHED = {"nodes": {"paper": 121751666, "author": 122383112, "institution": 25721},
             "edges": {"writes": 386022720, "affiliated_with": 44592586,
                       "cites": 1297748926},
             "directed_edges": 3456728464, "classes": 153, "feat_dim": 768,
             "splits": [1112392, 138949, 146818]}
SCALE = 1e-3
# (source type, destination type) of each relation id
PAIRS = [(1, 0), (0, 1), (1, 2), (2, 1), (0, 0)]


def mag240m(scale=SCALE, **kw):
    spec = json.loads((REPO / "gnnbench" / "graphs" / "mag240m.json").read_text())
    return dict(spec, scale=scale, **kw)


def build(spec):
    return ts.generate(**{k: v for k, v in spec.items() if k != "generator"})


@pytest.fixture(scope="module")
def mag():
    spec = mag240m()
    g = build(spec)
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    return spec, g, rows


def test_the_spec_is_mag240m_as_published():
    spec = mag240m(scale=1.0)
    assert {t["name"]: t["count"] for t in spec["node_types"]} == PUBLISHED["nodes"]
    assert {r["name"]: r["edges"] for r in spec["relations"]} == PUBLISHED["edges"]
    assert 2 * sum(PUBLISHED["edges"].values()) == PUBLISHED["directed_edges"]
    assert all(r["reverse"] for r in spec["relations"])
    assert (spec["num_classes"], spec["feat_dim"], spec["split_counts"]) == (
        PUBLISHED["classes"], PUBLISHED["feat_dim"], PUBLISHED["splits"])
    assert [(a, b) for _, a, b in ts.relation_list(spec)] == PAIRS


def test_only_the_schema_type_pairs_appear(mag):
    spec, g, rows = mag
    assert g.indptr.dtype == np.int64 and g.indices.dtype == np.int32
    rel = ts.relation_of(spec, g.indices.astype(np.int64), rows)
    assert rel.min() >= 0
    t_src, t_dst = ts.node_type_of(spec, g.indices), ts.node_type_of(spec, rows)
    pairs = set(zip(t_src.tolist(), t_dst.tolist()))
    assert pairs == set(PAIRS)


def test_each_relation_has_its_scaled_count_and_its_reverse(mag):
    spec, g, rows = mag
    rel = ts.relation_of(spec, g.indices.astype(np.int64), rows)
    got = np.bincount(rel, minlength=len(PAIRS))
    want = {"writes": 386023, "affiliated_with": 44593, "cites": 1297749}
    scaled = [want["writes"]] * 2 + [want["affiliated_with"]] * 2 + [2 * want["cites"]]
    for n, w in zip(got, scaled):
        assert abs(n - w) <= 0.02 * w, (got, scaled)
    assert g.num_edges == sum(scaled)
    n = g.num_nodes
    fwd = rows * n + g.indices
    back = np.sort(g.indices.astype(np.int64) * n + rows)
    np.testing.assert_array_equal(fwd, back)  # every edge's reverse is there


def test_rows_hold_distinct_ascending_sources_and_no_self_loop(mag):
    _, g, rows = mag
    step = np.diff(g.indices.astype(np.int64))
    assert np.all((step > 0) | (np.diff(rows) > 0))
    assert not np.any(g.indices == rows)


def test_same_seed_same_arrays_and_another_seed_others(mag):
    spec, g, _ = mag
    again = build(spec)
    for k in graph.GRAPH_FILES:
        np.testing.assert_array_equal(getattr(g, k), getattr(again, k))
    other = build(dict(spec, seed=1))
    assert not np.array_equal(g.indices, other.indices)


def test_the_cache_round_trips_under_a_name_of_its_own(tmp_path):
    spec = mag240m(scale=2e-4)
    a = graph.load_graph(spec, tmp_path)
    b = graph.load_graph(spec, tmp_path)
    for k in graph.GRAPH_FILES:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.num_classes, a.feat_dim) == (b.num_classes, b.feat_dim) == (153, 768)
    graph.load_graph(dict(spec, seed=5), tmp_path)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and all(n.startswith("typed_schema-") for n in names)
    assert graph._cache_name(dict(spec, scale=3e-4)) not in names


def test_labels_and_splits_lie_on_papers_only(mag):
    spec, g, _ = mag
    papers = ts.type_counts(spec)[0]
    assert g.labels[:papers].min() >= 0 and g.labels[:papers].max() < 153
    assert np.all(g.labels[papers:] == -1)
    splits = [g.train_idx, g.val_idx, g.test_idx]
    assert [s.size for s in splits] == [1112, 139, 147]
    every = np.concatenate(splits)
    assert every.max() < papers and np.unique(every).size == every.size


def test_papers_in_degrees_are_heavy_tailed(mag):
    spec, g, _ = mag
    papers = ts.type_counts(spec)[0]
    deg = np.diff(g.indptr)[:papers]
    assert deg.max() >= 20 * deg.mean()


@pytest.mark.parametrize("chunk", [997, 1 << 12])
def test_chunked_draws_keep_every_invariant(monkeypatch, chunk):
    """Chunks smaller than a relation: draws, redraws, merges and placement
    cross chunk edges (the arrays differ from one chunk size to another)."""
    monkeypatch.setattr(ts, "CHUNK", chunk)
    spec = mag240m(scale=1e-4)
    g = build(spec)
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    rel = ts.relation_of(spec, g.indices.astype(np.int64), rows)
    assert np.bincount(rel).tolist() == [38602, 38602, 4459, 4459, 2 * 129775]
    assert np.all((np.diff(g.indices.astype(np.int64)) > 0) | (np.diff(rows) > 0))
    fwd = rows * g.num_nodes + g.indices
    np.testing.assert_array_equal(fwd, np.sort(g.indices.astype(np.int64) * g.num_nodes + rows))


@pytest.mark.parametrize("chunk", [1, 3, 1 << 10])
def test_unique_sorted_in_place(monkeypatch, chunk):
    monkeypatch.setattr(ts, "CHUNK", chunk)
    keys = np.sort(np.random.default_rng(0).integers(0, 300, 2000))
    want = np.unique(keys)
    n = ts._unique_sorted_in_place(keys)
    np.testing.assert_array_equal(keys[:n], want)


def test_a_directed_relation_and_the_refusals():
    spec = {"node_types": [{"name": "a", "count": 300}, {"name": "b", "count": 50, "tail": 3.0}],
            "relations": [{"name": "r", "src": "a", "dst": "a", "edges": 2000},
                          {"name": "s", "src": "a", "dst": "b", "edges": 400, "reverse": True}],
            "labelled": "a", "num_classes": 4, "feat_dim": 8, "seed": 3}
    g = ts.generate(**spec)
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    rel = ts.relation_of(spec, g.indices.astype(np.int64), rows)
    assert np.bincount(rel).tolist() == [2000, 400, 400]
    assert g.train_idx.size == 180 and g.labels[300:].tolist() == [-1] * 50
    with pytest.raises(ValueError, match="possible"):
        ts.generate(**dict(spec, relations=[dict(spec["relations"][1], edges=8000)]))
    with pytest.raises(ValueError, match="the same way"):
        ts.generate(**dict(spec, relations=spec["relations"] + [
            {"name": "t", "src": "b", "dst": "a", "edges": 5}]))


def test_generators_are_found_by_file_and_refused_by_name(tmp_path):
    assert graph.generator("typed_schema").__module__ == "gnnbench_graphs_typed_schema"
    assert graph.generator("planted_partition") is graph.planted_partition
    for bad in ("no_such_graph", "../graph", "mag240m"):
        with pytest.raises(ValueError, match="no graph generator"):
            graph.load_graph({"generator": bad, "num_classes": 2, "feat_dim": 2}, tmp_path)
    planted = dict(generator="planted_partition", num_nodes=5000, avg_degree=8, num_classes=5,
                   feat_dim=8, seed=1, homophily=0.8, split_counts=None)
    assert graph._cache_name(planted) == "planted_partition-n5000-d8-c5-s1"

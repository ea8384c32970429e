"""The port's graph host layer against the JAX package: datasets, CSR,
sampler and reorder.  Graphs stay below 100K edges so both sides take
their numpy CSR paths, and both samplers are pinned to their numpy paths
(tests/test_torch_reorder.py holds the native paths to each other)."""

import numpy as np
import pytest

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

import falcon_ttdforgnns_tpu.graph.sampler as jax_sampler
from falcon_ttdforgnns_tpu.graph import csr as jax_csr
from falcon_ttdforgnns_tpu.graph import reorder as jax_reorder

from falcon_ttdforgnns_torch.graph import csr, reorder, sampler


def assert_same_dataset(a, b):
    np.testing.assert_array_equal(a.graph.indptr, b.graph.indptr)
    np.testing.assert_array_equal(a.graph.indices, b.graph.indices)
    np.testing.assert_array_equal(a.labels, b.labels)
    for s in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(a, s), getattr(b, s))
    assert (a.num_classes, a.feat_dim, a.num_nodes) == (b.num_classes, b.feat_dim, b.num_nodes)


@pytest.mark.parametrize("kind,seed", [("synthetic", 0), ("synthetic", 5),
                                       ("hard", 0), ("hard", 5)])
def test_synthetic_datasets_match(kind, seed):
    fn = "synthetic_dataset" if kind == "synthetic" else "hard_synthetic_dataset"
    kw = dict(num_nodes=4000, avg_degree=6, num_classes=7, feat_dim=32, seed=seed)
    a, b = getattr(csr, fn)(**kw), getattr(jax_csr, fn)(**kw)
    assert a.graph.num_edges < 100_000
    assert_same_dataset(a, b)


def test_get_dataset_matches_including_official_split():
    a = csr.get_dataset("hard-ogbn-arxiv", synthetic_scale=0.01, seed=3)
    b = jax_csr.get_dataset("hard-ogbn-arxiv", synthetic_scale=0.01, seed=3)
    assert_same_dataset(a, b)
    with pytest.raises(ValueError):
        csr.get_dataset("ogbn-arxiv", synthetic_scale=0.01, official_split=True)


def test_random_permutation_and_permute_match():
    ds = csr.hard_synthetic_dataset(num_nodes=3000, avg_degree=5, seed=2)
    jds = jax_csr.hard_synthetic_dataset(num_nodes=3000, avg_degree=5, seed=2)
    perm = reorder.reorder_permutation(ds.graph, 0, seed=9)
    np.testing.assert_array_equal(perm, jax_reorder.random_permutation(jds.graph, seed=9))
    assert_same_dataset(ds.permute(perm), jds.permute(perm))


def test_from_edges_matches_with_dedup():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 500, 4000), rng.integers(0, 500, 4000)
    for kw in (dict(add_reverse=True), dict(add_reverse=False, dedup=True)):
        a = csr.CSRGraph.from_edges(src, dst, 500, **kw)
        b = jax_csr.CSRGraph.from_edges(src, dst, 500, **kw)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)


@pytest.fixture
def jax_numpy_sampler(monkeypatch):
    """Both samplers' native handles off: the numpy paths run."""
    monkeypatch.setattr(jax_sampler, "_native", None)
    monkeypatch.setattr(sampler, "_native", None)
    return jax_sampler


def test_sample_block_matches_numpy_path(jax_numpy_sampler):
    ds = csr.hard_synthetic_dataset(num_nodes=3000, avg_degree=5, seed=4)
    seeds = np.random.default_rng(1).choice(ds.num_nodes, 64, replace=False)
    a = sampler.sample_block(ds.graph, seeds, (3, 4, 5), np.random.default_rng(11))
    b = jax_numpy_sampler.sample_block(ds.graph, seeds, (3, 4, 5),
                                       np.random.default_rng(11))
    np.testing.assert_array_equal(a.seeds, b.seeds)
    for la, lb in zip(a.layers, b.layers):
        np.testing.assert_array_equal(la, lb)
    # fan-outs are listed innermost first: the seeds' neighbors use the last
    assert [l.shape for l in a.layers] == [(64, 5), (64, 20), (64, 60)]


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_matches_numpy_path(jax_numpy_sampler, workers):
    ds = csr.hard_synthetic_dataset(num_nodes=3000, avg_degree=5, seed=4)
    args = (ds.graph, ds.train_idx, ds.labels, (2, 3), 100)
    ours = sampler.NeighborLoader(*args, seed=5, num_workers=workers)
    ref = jax_numpy_sampler.NeighborLoader(*args, seed=5, num_workers=workers)
    n = 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.all_nodes, b.all_nodes)
        np.testing.assert_array_equal(a.labels, b.labels)
        n += 1
    assert n == len(ours) == len(ref)


def test_sampler_shapes_ranges_and_self_loops():
    # nodes 6..9 are isolated: their samples are themselves
    g = csr.CSRGraph.from_edges(np.array([0, 1, 2, 3, 4]), np.array([1, 2, 3, 4, 5]), 10)
    seeds = np.arange(10)
    blk = sampler.sample_block(g, seeds, (2, 3), np.random.default_rng(0))
    assert [l.shape for l in blk.layers] == [(10, 3), (10, 6)]
    assert all(l.dtype == np.int32 for l in blk.layers)
    for l in blk.layers:
        assert l.min() >= 0 and l.max() < 10
    for v in range(6, 10):
        assert (blk.layers[0][v] == v).all() and (blk.layers[1][v] == v).all()
    for v in range(6):
        nbrs = set(g.indices[g.indptr[v]:g.indptr[v + 1]].tolist())
        assert set(blk.layers[0][v].tolist()) <= nbrs


def test_loader_wraps_ragged_tail_to_full_batches():
    ds = csr.hard_synthetic_dataset(num_nodes=1000, avg_degree=4, seed=0)
    loader = sampler.NeighborLoader(ds.graph, ds.train_idx[:130], ds.labels, (2,), 64)
    batches = list(loader)
    assert len(batches) == 2 and all(b.seeds.shape == (64,) for b in batches)

"""The port's native host runtime and node reorderings against the JAX
package: the native CSR builder, sampler and R-MAT generator give identical
arrays; every ``--partition`` code gives the identical permutation on the
same graph and seed (through the native partitioner, and through the numpy
functions with both packages' native handles off); the disk-cached reorder
and its memo; the host caches; the library builds into the port's own
``build/``."""

import numpy as np
import pytest

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401 (a fixture)

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

import falcon_ttdforgnns_tpu.graph.reorder as jax_reorder
import falcon_ttdforgnns_tpu.graph.sampler as jax_sampler
from falcon_ttdforgnns_tpu.graph import _native as jax_runtime
from falcon_ttdforgnns_tpu.graph import csr as jax_csr
from falcon_ttdforgnns_tpu.utils import host_cache as jax_host_cache

from falcon_ttdforgnns_torch.graph import _native, csr, reorder, sampler
from falcon_ttdforgnns_torch.ops import _build
from falcon_ttdforgnns_torch.utils import host_cache

LEVELS = [10, 15, 20]  # --partition -1's TT p-shapes for 3000 nodes


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=3000, avg_degree=5, seed=2)
    return csr.hard_synthetic_dataset(**kw).graph, jax_csr.hard_synthetic_dataset(**kw).graph


def test_library_builds_into_the_ports_build_dir():
    so = _build.build_host("falcon_native")
    assert so.parent == _build.BUILD_DIR and so.exists()
    assert so == _build.host_library_path("falcon_native")
    assert "falcon_ttdforgnns_tpu" not in str(so)
    assert _native.version() == jax_runtime.VERSION == 1
    with pytest.raises(ValueError):
        _build.host_library_path("tt_kernels")


def test_native_source_is_the_reference_copy():
    """Below its header the port's source is the JAX package's, byte for
    byte."""
    import pathlib
    repo = pathlib.Path(__file__).resolve().parent.parent
    ours = (repo / "falcon_ttdforgnns_torch/csrc/falcon_native.cpp").read_text()
    ref = (repo / "falcon_ttdforgnns_tpu/csrc/falcon_native.cpp").read_text()
    body = "#include <algorithm>"
    assert ours[ours.index(body):] == ref[ref.index(body):]


@pytest.mark.parametrize("add_reverse", [True, False])
def test_native_build_csr_identical(jax_native, add_reverse):
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 5000, 150_000), rng.integers(0, 5000, 150_000)
    a = _native.build_csr(src, dst, 5000, add_reverse)
    b = jax_runtime.build_csr(src, dst, 5000, add_reverse)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # over 100K edges from_edges takes it in both packages
    g = csr.CSRGraph.from_edges(src, dst, 5000, add_reverse=add_reverse)
    jg = jax_csr.CSRGraph.from_edges(src, dst, 5000, add_reverse=add_reverse)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    np.testing.assert_array_equal(g.indptr, a[0])


@pytest.mark.parametrize("num_edges", [60_000, 600_000])
def test_rmat_edges_identical(jax_native, num_edges):
    """Below 500K edges both packages draw R-MAT in numpy, above natively."""
    a = csr.rmat_edges(40_000, num_edges, seed=3)
    b = jax_csr.rmat_edges(40_000, num_edges, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if num_edges > 500_000:
        for x, y in zip(a, _native.rmat_edges(40_000, num_edges, seed=3)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fanouts", [(3, 4, 5), (15, 10, 5)])
def test_native_sample_block_multi_identical(jax_native, graphs, fanouts):
    g, jg = graphs
    seeds = np.random.default_rng(1).choice(g.num_nodes, 256, replace=False)
    a = _native.sample_block_multi(g.indptr, g.indices, seeds, fanouts, 77)
    b = jax_runtime.sample_block_multi(jg.indptr, jg.indices, seeds, fanouts, 77)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the sampler draws the native seed from the generator as JAX does
    blk = sampler.sample_block(g, seeds, fanouts, np.random.default_rng(11))
    jblk = jax_sampler.sample_block(jg, seeds, fanouts, np.random.default_rng(11))
    for x, y in zip(blk.layers, jblk.layers):
        np.testing.assert_array_equal(x, y)
    nodes = seeds.astype(np.int64)
    np.testing.assert_array_equal(
        sampler._sample_neighbors(g, nodes, 4, np.random.default_rng(5)),
        jax_sampler._sample_neighbors(jg, nodes, 4, np.random.default_rng(5)))


@pytest.mark.parametrize("workers", [1, 3])
def test_native_loader_batches_and_freq_identical(jax_native, graphs, workers):
    """The loader's batches and its access counts (np.bincount here,
    np.add.at in JAX) are the JAX loader's."""
    g, jg = graphs
    labels = np.arange(g.num_nodes) % 4
    train = np.arange(0, g.num_nodes, 3)
    ours = sampler.NeighborLoader(g, train, labels, (2, 3), 100, seed=5,
                                  num_workers=workers)
    ref = jax_sampler.NeighborLoader(jg, train, labels, (2, 3), 100, seed=5,
                                     num_workers=workers)
    for _ in range(2):  # the counts accumulate over epochs
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.all_nodes, b.all_nodes)
    assert ours.freq.dtype == ref.freq.dtype == np.int64
    np.testing.assert_array_equal(ours.freq, ref.freq)
    assert ours.freq.sum() == 2 * len(ours) * 100 * (1 + 3 + 6)
    off = sampler.NeighborLoader(g, train, labels, (2, 3), 100, track_freq=False)
    next(iter(off))
    assert off.freq is None


@pytest.mark.parametrize("partition", [8, 128, 0, -1, -2, -3, -4])
def test_every_partition_code_identical(jax_native, graphs, partition):
    g, jg = graphs
    perm = reorder.reorder_permutation(g, partition, levels=LEVELS, seed=1)
    want = jax_reorder.reorder_permutation(jg, partition, levels=LEVELS, seed=1)
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(np.sort(perm), np.arange(g.num_nodes))
    assert reorder.reorder_permutation(g, -5) is None  # JAX's no-op code


@pytest.fixture
def numpy_paths(monkeypatch):
    """Both packages' native handles off: their numpy functions run."""
    monkeypatch.setattr(reorder, "_native", None)
    monkeypatch.setattr(jax_reorder, "_native", None)


@pytest.mark.parametrize("partition", [8, -1])
def test_numpy_partition_functions_identical(numpy_paths, partition):
    kw = dict(num_nodes=600, avg_degree=4, seed=3)
    g = csr.hard_synthetic_dataset(**kw).graph
    jg = jax_csr.hard_synthetic_dataset(**kw).graph
    np.testing.assert_array_equal(
        reorder.reorder_permutation(g, partition, levels=[4, 5, 30], seed=2),
        jax_reorder.reorder_permutation(jg, partition, levels=[4, 5, 30], seed=2))
    np.testing.assert_array_equal(reorder.partition_graph(g, 6, seed=4, coarsen_to=50),
                                  jax_reorder.partition_graph(jg, 6, seed=4, coarsen_to=50))


def test_reorder_cache_hits_disk_and_memo(graphs, tmp_path, monkeypatch):
    g, jg = graphs
    monkeypatch.setattr(reorder, "_PERM_MEMO", None)  # memos of this test's own
    monkeypatch.setattr(jax_reorder, "_PERM_MEMO", None)
    calls = []
    real = reorder.reorder_permutation
    monkeypatch.setattr(reorder, "reorder_permutation",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    perm = reorder.reorder_permutation_cached(g, -3, cache_dir=str(tmp_path), seed=1)
    files = list(tmp_path.glob("perm_*.npy"))
    assert calls == [-3] and len(files) == 1
    np.testing.assert_array_equal(np.load(files[0]), perm)
    np.testing.assert_array_equal(perm, jax_reorder.reorder_permutation_cached(
        jg, -3, cache_dir=str(tmp_path / "jax"), seed=1))
    # the JAX package keys its files the same way
    assert [f.name for f in (tmp_path / "jax").glob("perm_*.npy")] == [files[0].name]
    # the memo answers without a file read; with the memo gone, the file does
    assert reorder.reorder_permutation_cached(g, -3, cache_dir=str(tmp_path), seed=1) is perm
    monkeypatch.setattr(reorder, "_PERM_MEMO", None)
    again = reorder.reorder_permutation_cached(g, -3, cache_dir=str(tmp_path), seed=1)
    np.testing.assert_array_equal(again, perm)
    assert calls == [-3]
    # partition 0 is never cached
    reorder.reorder_permutation_cached(g, 0, cache_dir=str(tmp_path), seed=1)
    assert calls == [-3, 0] and len(list(tmp_path.glob("perm_*.npy"))) == 1


def test_host_caches_match():
    ours, ref = host_cache.LRUCache(2), jax_host_cache.LRUCache(2)
    for op, key in (("put", 1), ("put", 2), ("get", 1), ("put", 3), ("get", 2),
                    ("get", 3), ("get", 1)):
        got = [getattr(c, op)(key, key * 10) if op == "put" else c.get(key)
               for c in (ours, ref)]
        assert got[0] == got[1]
    assert ours.stats() == ref.stats() == {"hits": 3, "misses": 1}

"""The benchmark's numpy copy of the generator gives the port's arrays."""

import numpy as np
import pytest

from falcon_ttdforgnns_torch.graph.csr import get_dataset, hard_synthetic_dataset
from gnnbench.graph import edge_keys, load_graph, planted_partition

PRODUCTS = dict(avg_degree=25, num_classes=47, feat_dim=100, homophily=0.8)


def same(g, ds):
    np.testing.assert_array_equal(g.indptr, ds.graph.indptr)
    np.testing.assert_array_equal(g.indices, ds.graph.indices)
    for k in ("labels", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(g, k), getattr(ds, k))
    assert (g.num_classes, g.feat_dim) == (ds.num_classes, ds.feat_dim)


def test_products_at_a_hundredth_is_the_ports():
    ds = get_dataset("hard-ogbn-products", synthetic_scale=0.01, seed=0)
    same(planted_partition(num_nodes=ds.num_nodes, seed=0, split_counts=None, **PRODUCTS), ds)


@pytest.mark.parametrize("seed", [0, 3])
def test_official_split_counts_are_the_ports(seed):
    kw = dict(num_nodes=30000, split_counts=(3000, 1000, 20000), seed=seed, **PRODUCTS)
    same(planted_partition(**kw), hard_synthetic_dataset(name="x", **kw))


def test_cache_round_trip(tmp_path):
    spec = dict(generator="planted_partition", num_nodes=5000, avg_degree=8, num_classes=5,
                feat_dim=8, seed=1, homophily=0.8, split_counts=[500, 500, 1000])
    a = load_graph(spec, tmp_path)
    b = load_graph(spec, tmp_path)
    for k in ("indptr", "indices", "labels", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    keys = edge_keys(a)
    assert np.all(np.diff(keys) >= 0) and keys.shape[0] == a.num_edges

"""The port's in-step sampler (``graph/device_sampler.py``) against the JAX
package's, on the CPU.

``build_neighbor_table`` is host numpy in both packages and is held bit for
bit.  The device samplers draw from ``torch.Generator`` bits, not
``jax.random``'s, so they are held to what the sampling means: every id in
range, each an in-neighbour of its parent or the parent itself when it is
isolated, the JAX samplers' layer shapes, and the uniformity bound of the
JAX package's own test (``tests/test_flags.py``, ``TestPureGPUMode``: each
neighbour's count within 4 binomial sigma + 1 of its multiplicity-weighted
share).  The graph is tiny and has isolated nodes; its arrays come from a
seeded numpy generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph import device_sampler as J

from falcon_ttdforgnns_torch.graph import device_sampler as S

FANOUTS = (3, 4, 5)


@pytest.fixture(scope="module")
def graph():
    """(indptr, indices) int64 of 300 nodes: degrees 0-12 (one node of
    degree 40, repeated neighbours allowed), every tenth node isolated."""
    rng = np.random.default_rng(11)
    n = 300
    deg = rng.integers(1, 13, n)
    deg[::10] = 0
    deg[7] = 40
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, indptr[-1]).astype(np.int64)
    return indptr, indices


def check_members(indptr, indices, parents, children):
    """Each child (a row of draws per parent) is an in-neighbour of its
    parent, or the parent itself when the parent is isolated; all in range."""
    n = indptr.shape[0] - 1
    parents, children = np.asarray(parents).reshape(-1), np.asarray(children)
    children = children.reshape(parents.shape[0], -1)
    assert children.min() >= 0 and children.max() < n
    for p, row in zip(parents, children):
        neigh = indices[indptr[p]:indptr[p + 1]]
        if len(neigh):
            assert set(row.tolist()) <= set(neigh.tolist())
        else:
            assert (row == p).all()


def within_4_sigma(draws, neigh):
    """The JAX test's bound: each distinct neighbour's count within
    4 sigma + 1 of its multiplicity-weighted binomial mean."""
    uniq, mult = np.unique(neigh, return_counts=True)
    counts = np.bincount(np.searchsorted(uniq, draws), minlength=len(uniq))
    p = mult / len(neigh)
    sigma = np.sqrt(len(draws) * p * (1 - p))
    assert set(np.unique(draws).tolist()) <= set(uniq.tolist())
    assert (np.abs(counts - len(draws) * p) < 4 * sigma + 1).all()


@pytest.mark.parametrize("seed,width", [(0, 1), (3, 8), (7, 33), (5, 64)])
def test_neighbor_table_bit_identical_to_jax(graph, seed, width):
    indptr, indices = graph
    got = S.build_neighbor_table(indptr, indices, width, seed)
    want = J.build_neighbor_table(indptr, indices, width, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    check_members(indptr, indices, np.arange(len(indptr) - 1), got)


def test_neighbor_table_edgeless_graph_bit_identical_to_jax():
    indptr, indices = np.zeros(6, np.int64), np.zeros(0, np.int64)
    got = S.build_neighbor_table(indptr, indices, 4, 0)
    np.testing.assert_array_equal(got, J.build_neighbor_table(indptr, indices, 4, 0))
    np.testing.assert_array_equal(got, np.repeat(np.arange(5, dtype=np.int32)[:, None], 4, 1))


def test_sample_neighbors_members_and_isolated(graph):
    indptr, indices = graph
    gen = torch.Generator().manual_seed(0)
    nodes = torch.arange(len(indptr) - 1, dtype=torch.int32)
    got = S.device_sample_neighbors(torch.tensor(indptr, dtype=torch.int32),
                                    torch.tensor(indices, dtype=torch.int32), nodes, 6, gen)
    assert got.dtype == torch.int32 and got.shape == (len(nodes), 6)
    check_members(indptr, indices, nodes.numpy(), got.numpy())
    # the JAX sampler's own contract on the same nodes, for the record
    want = np.asarray(J.device_sample_neighbors(jnp.asarray(indptr.astype(np.int32)),
                                                jnp.asarray(indices.astype(np.int32)),
                                                jnp.asarray(nodes.numpy()), 6,
                                                jax.random.PRNGKey(0)))
    assert want.shape == tuple(got.shape)
    check_members(indptr, indices, nodes.numpy(), want)


def test_sample_neighbors_edgeless_graph():
    gen = torch.Generator().manual_seed(0)
    nodes = torch.tensor([0, 3, 4], dtype=torch.int32)
    got = S.device_sample_neighbors(torch.zeros(6, dtype=torch.int32),
                                    torch.zeros(0, dtype=torch.int32), nodes, 2, gen)
    np.testing.assert_array_equal(got.numpy(), [[0, 0], [3, 3], [4, 4]])


def test_sample_neighbors_uniform(graph):
    """The highest-degree node (40 in-edges, repeats among them) drawn
    4,096 times: the JAX test's 4-sigma bound per neighbour."""
    indptr, indices = graph
    v = int(np.argmax(np.diff(indptr)))
    gen = torch.Generator().manual_seed(1)
    draws = S.device_sample_neighbors(torch.tensor(indptr, dtype=torch.int32),
                                      torch.tensor(indices, dtype=torch.int32),
                                      torch.tensor([v], dtype=torch.int32), 4096, gen)
    within_4_sigma(draws.numpy().reshape(-1), indices[indptr[v]:indptr[v + 1]])


def test_below_stays_below_its_bound():
    """The scaled 32-bit draw never reaches its bound, at 1 and near 2^31."""
    gen = torch.Generator().manual_seed(2)
    bound = torch.tensor([1, 2, 3, 7, 2**31 - 1], dtype=torch.int64)
    got = S._below(bound, 20000, gen)
    assert (got >= 0).all() and (got < bound[:, None]).all()
    assert (got[0] == 0).all() and set(got[1].tolist()) == {0, 1}


def layer_parents(seeds, layers, fanouts):
    """(parents, children) of each hop: the previous level's ids, repeated
    per draw, and the level's."""
    prev = seeds.reshape(-1, 1)
    for f, lay in zip(reversed(fanouts), layers):
        yield prev.reshape(-1), lay.reshape(-1, f)
        prev = lay


@pytest.mark.parametrize("sampler", ["csr", "table"])
def test_sample_block_contract_and_members(graph, sampler):
    """Both block samplers give the JAX samplers' layer shapes and int32,
    and every hop's ids are in-neighbours of their parents (or the isolated
    parent itself)."""
    indptr, indices = graph
    seeds = np.random.default_rng(4).integers(0, len(indptr) - 1, 16).astype(np.int32)
    gen = torch.Generator().manual_seed(3)
    if sampler == "csr":
        got = S.device_sample_block(torch.tensor(indptr, dtype=torch.int32),
                                    torch.tensor(indices, dtype=torch.int32),
                                    torch.tensor(seeds), FANOUTS, gen)
        want = J.device_sample_block(jnp.asarray(indptr.astype(np.int32)),
                                     jnp.asarray(indices.astype(np.int32)),
                                     jnp.asarray(seeds), FANOUTS, jax.random.PRNGKey(0))
    else:
        table = S.build_neighbor_table(indptr, indices, 16, 0)
        got = S.device_sample_block_table(torch.tensor(table), torch.tensor(seeds), FANOUTS,
                                          gen)
        want = J.device_sample_block_table(jnp.asarray(table), jnp.asarray(seeds), FANOUTS,
                                           jax.random.PRNGKey(0))
    assert [tuple(l.shape) for l in got] == [tuple(l.shape) for l in want] == [
        (16, 5), (16, 20), (16, 60)]
    assert all(l.dtype == torch.int32 for l in got)
    for parents, children in layer_parents(seeds, [l.numpy() for l in got], FANOUTS):
        check_members(indptr, indices, parents, children)


def test_table_sampler_uniform_over_slots(graph):
    """The table sampler draws a uniform slot: the highest-degree node's
    4,096 draws hold each of its row's values to the row's share of it
    (the JAX 4-sigma bound), and never leave the row."""
    indptr, indices = graph
    v = int(np.argmax(np.diff(indptr)))
    table = S.build_neighbor_table(indptr, indices, 16, 9)
    gen = torch.Generator().manual_seed(5)
    draws = S.device_sample_block_table(torch.tensor(table), torch.tensor([v], dtype=torch.int32),
                                        (4096,), gen)[0]
    within_4_sigma(draws.numpy().reshape(-1), table[v])


def test_neighbor_table_uniform_over_neighbours(graph):
    """The JAX test's check of the table itself, on the port's copy: a
    2,048-wide row of the highest-degree node within the 4-sigma bound."""
    indptr, indices = graph
    v = int(np.argmax(np.diff(indptr)))
    wide = S.build_neighbor_table(indptr, indices, 2048, 5)
    within_4_sigma(wide[v], indices[indptr[v]:indptr[v + 1]])

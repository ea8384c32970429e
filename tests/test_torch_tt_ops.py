"""The port's TT ops against the JAX package: shapes and init, the lookup
(B1), its gradients (B2) and the fused Adam update (B3).

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs the Pallas kernels in interpret mode with f32 compute (their CPU
default); the port's side runs its plain versions, which is what its
wrappers do for CPU tensors.  The CUDA kernels themselves are held against
the plain versions by tests/test_torch_cuda.py and chip_smoke.py on the
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_ttdforgnns_tpu.ops import tt_init as jax_tt_init
from falcon_ttdforgnns_tpu.ops import tt_shapes as jax_tt_shapes
from falcon_ttdforgnns_tpu.ops.tt_lookup import (tt_core_grads as jax_core_grads,
                                                 tt_lookup_gather as jax_gather)
from falcon_ttdforgnns_tpu.ops.tt_pallas import (tt_fused_adam_pallas,
                                                 tt_grads_pallas,
                                                 tt_lookup_pallas,
                                                 tt_lookup_pallas_padded)
from falcon_ttdforgnns_tpu.utils.config import DATASET_PRESETS
from falcon_ttdforgnns_tpu.graph.csr import DATASET_SCALES

from falcon_ttdforgnns_torch.nn.tt_embedding import TTEmbeddingBag, init_cores
from falcon_ttdforgnns_torch.ops import tt_init, tt_kernels
from falcon_ttdforgnns_torch.ops.tt_kernels import (TTLookup, tt_adam_apply,
                                                    tt_fused_adam, tt_fwd,
                                                    tt_grads)
from falcon_ttdforgnns_torch.ops.tt_lookup import (tt_digits, tt_lookup_batched,
                                                   tt_lookup_gather, tt_to_full)
from falcon_ttdforgnns_torch.ops.tt_shapes import TTShapes, make_tt_shapes

DISTS = ["uniform", "naive-uniform", "normal", "approx-normal", "approx-uniform"]


def assert_close(got, want, rtol):
    """Elementwise rtol plus an absolute floor of rtol * max|want|, so
    values near zero are judged on the array's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def case_for(ndim):
    """The 2/3/4-core shapes of tests/test_pallas.py:57-69."""
    if ndim == 2:
        shapes = TTShapes(256, 64, (16, 16), (8, 8), (12,))
    elif ndim == 3:
        shapes = TTShapes(int(np.prod((10, 12, 14))), 60, (10, 12, 14), (3, 4, 5), (8, 8))
    else:
        shapes = TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))
    return shapes, tt_init.init_tt_cores(shapes, "normal", 0)


def products_case():
    shapes = make_tt_shapes(2_449_029, 100, (16, 16), (125, 140, 140), (5, 5, 4))
    return shapes, tt_init.init_tt_cores(shapes, "normal", 0)


def torch_cores(cores):
    return [torch.tensor(c) for c in cores]


def jax_cores(cores):
    return tuple(jnp.asarray(c) for c in cores)


def ids_with_duplicates(rng, n, B):
    ids = rng.integers(0, n, B).astype(np.int32)
    ids[B // 2:B // 2 + 16] = ids[:16]  # repeated ids must accumulate
    return ids


# --------------------------------------------------------- shapes and init
@pytest.mark.parametrize("name", sorted(DATASET_PRESETS))
def test_preset_shapes_and_strides_match(name):
    pre = DATASET_PRESETS[name]
    sc = DATASET_SCALES[name]
    args = (sc["num_nodes"], sc["feat_dim"], (16, 16), pre["p_shapes"], pre["q_shapes"])
    ours, ref = make_tt_shapes(*args), jax_tt_shapes.make_tt_shapes(*args)
    assert ours.strides == ref.strides
    assert ours.core_shapes == ref.core_shapes
    assert ours.num_tt_params == ref.num_tt_params
    assert (make_tt_shapes(sc["num_nodes"], sc["feat_dim"]).p_shapes
            == jax_tt_shapes.make_tt_shapes(sc["num_nodes"], sc["feat_dim"]).p_shapes)


@pytest.mark.parametrize("dist", DISTS)
def test_init_cores_bit_identical(dist):
    shapes = make_tt_shapes(2_449_029, 100, (16, 16), (125, 140, 140), (5, 5, 4))
    ref = jax_tt_shapes.make_tt_shapes(2_449_029, 100, (16, 16), (125, 140, 140), (5, 5, 4))
    for seed in (0, 3):
        for a, b in zip(tt_init.init_tt_cores(shapes, dist, seed),
                        jax_tt_init.init_tt_cores(ref, dist, seed)):
            np.testing.assert_array_equal(a, b)


def test_embedding_init_uses_per_core_seed_offset():
    """Core k of the module comes from init_tt_cores(seed + 7919*k)[k], as
    in the JAX module (nn/tt_embedding.py:42-61)."""
    from falcon_ttdforgnns_tpu.nn.tt_embedding import _cores_for
    shapes = make_tt_shapes(5000, 64, (4, 4))
    ref_shapes = jax_tt_shapes.make_tt_shapes(5000, 64, (4, 4))
    emb = TTEmbeddingBag(5000, 64, (4, 4), weight_dist="approx-normal", init_seed=2)
    for k, c in enumerate(emb.cores):
        want = _cores_for(ref_shapes, "approx-normal", 2 + 7919 * k)[k]
        np.testing.assert_array_equal(c.detach().numpy(), want)
    assert [c.shape for c in init_cores(shapes, "normal", 0)] == shapes.core_shapes


def test_digit_roundtrip():
    shapes, _ = case_for(4)
    idx = torch.arange(shapes.num_embeddings)
    rebuilt = sum(d * s for d, s in zip(tt_digits(shapes, idx), shapes.strides))
    assert torch.equal(rebuilt, idx)


# -------------------------------------------------------------- B1 lookup
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_lookup_matches_pallas_and_gather(ndim):
    shapes, cores = case_for(ndim)
    ids = np.random.default_rng(ndim).integers(0, shapes.num_embeddings, 384).astype(np.int32)
    ours = tt_fwd(shapes, torch_cores(cores), torch.tensor(ids)).numpy()
    pallas = tt_lookup_pallas(shapes, jax_cores(cores), jnp.asarray(ids), block=128,
                              compute_dtype=jnp.float32)
    assert_close(ours, pallas, rtol=1e-5)
    assert_close(ours, jax_gather(shapes, jax_cores(cores), jnp.asarray(ids)), rtol=1e-5)


def test_lookup_products_shapes():
    shapes, cores = products_case()
    ids = np.random.default_rng(2).integers(0, shapes.num_embeddings, 3000).astype(np.int32)
    ours = tt_fwd(shapes, torch_cores(cores), torch.tensor(ids)).numpy()
    pallas = tt_lookup_pallas_padded(shapes, jax_cores(cores), jnp.asarray(ids),
                                     block=1024, compute_dtype=jnp.float32)
    assert_close(ours, pallas, rtol=1e-4)  # test_pallas.py:53's products tolerance


def test_lookup_ragged_batch():
    shapes, cores = case_for(3)
    ids = np.random.default_rng(1).integers(0, shapes.num_embeddings, 333).astype(np.int32)
    ours = tt_fwd(shapes, torch_cores(cores), torch.tensor(ids)).numpy()
    pallas = tt_lookup_pallas_padded(shapes, jax_cores(cores), jnp.asarray(ids),
                                     block=128, compute_dtype=jnp.float32)
    assert ours.shape == (333, shapes.embedding_dim)
    assert_close(ours, pallas, rtol=1e-5)


def test_full_table_and_batched_lookup():
    shapes, cores = case_for(3)
    tc = torch_cores(cores)
    full = tt_to_full(shapes, tc)
    ids = torch.arange(shapes.num_embeddings)
    assert_close(full.numpy(), tt_lookup_gather(shapes, tc, ids).numpy(), rtol=1e-5)
    assert_close(tt_lookup_batched(shapes, tc, ids, batch_count=100).numpy(),
                 full.numpy(), rtol=1e-5)


def test_embedding_bag_pooling():
    shapes, cores = case_for(2)
    emb = TTEmbeddingBag(256, 64, (12,), (16, 16), (8, 8), precomputed_cores=cores)
    ids = torch.tensor([3, 7, 7, 200, 5])
    pooled = emb(ids, offsets=torch.tensor([0, 2, 2, 5]))
    rows = emb(ids)
    torch.testing.assert_close(pooled, torch.stack(
        [rows[:2].sum(0), torch.zeros(64), rows[2:].sum(0)]), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- B2 grads
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_grads_match_pallas(ndim):
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(10 + ndim)
    ids = ids_with_duplicates(rng, shapes.num_embeddings, 256)
    g = rng.normal(size=(256, shapes.embedding_dim)).astype(np.float32)
    ours = tt_grads(shapes, torch_cores(cores), torch.tensor(ids), torch.tensor(g))
    want = tt_grads_pallas(shapes, jax_cores(cores), jnp.asarray(ids), jnp.asarray(g),
                           block=128, compute_dtype=jnp.float32)
    ref = jax_core_grads(shapes, jax_cores(cores), jnp.asarray(ids), jnp.asarray(g),
                         dedup=True)
    for a, b, c in zip(ours, want, ref):
        assert_close(a.numpy(), b, rtol=1e-4)
        assert_close(a.numpy(), c, rtol=1e-4)


def grouped_ids(rng, kind, n):
    """The id draws of the grouped backward's cases: (ids, chunk)."""
    if kind == "runs_and_duplicates":  # long runs of few ids, shuffled among singles
        ids = np.concatenate([np.repeat(rng.integers(0, n, 6), rng.integers(5, 40, 6)),
                              rng.integers(0, n, 120)])
        return rng.permutation(ids), 16
    if kind == "run_past_chunks":  # one id's run spans several chunks of 16
        return rng.permutation(np.concatenate([np.full(70, n // 3), rng.integers(0, n, 60)])), 16
    if kind == "one_id":  # a single id over the whole batch
        return np.full(200, n - 1), 64
    return np.array([n // 2]), 64  # B = 1


def pallas_grads_padded(shapes, cores, ids, g, block=128):
    """tt_grads_pallas (interpret mode, f32) on B padded to its block with
    zero d_out rows, which add nothing."""
    pad = -len(ids) % block
    ids = np.concatenate([ids, np.zeros(pad, ids.dtype)])
    g = np.concatenate([g, np.zeros((pad, g.shape[1]), g.dtype)])
    return tt_grads_pallas(shapes, jax_cores(cores), jnp.asarray(ids), jnp.asarray(g),
                           block=block, compute_dtype=jnp.float32)


@pytest.mark.parametrize("kind", ["runs_and_duplicates", "run_past_chunks", "one_id", "b1"])
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_grouped_grads_match_pallas(ndim, kind):
    """The card kernel's order in plain PyTorch (tt_grads_grouped_plain: the
    wrapper's sort, equal ids summed, one flush per prefix within a chunk)
    against tt_core_grads and the Pallas backward: rtol 1e-5 with a floor
    of 1e-5 of each core's largest value.  Both sum the same f32 products
    in other orders over at most a few hundred terms, so they differ by
    about sqrt(B) * 2^-24 of the sum (~1e-6), not by the 1e-4 the card's
    atomics are allowed."""
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(80 + ndim)
    ids, chunk = grouped_ids(rng, kind, shapes.num_embeddings)
    ids = ids.astype(np.int32)
    g = rng.normal(size=(len(ids), shapes.embedding_dim)).astype(np.float32)
    ours = tt_kernels.tt_grads_grouped_plain(shapes, torch_cores(cores), torch.tensor(ids),
                                             torch.tensor(g), chunk)
    counts = tt_kernels.grouped_counts(shapes, torch.tensor(ids), chunk)
    if kind in ("run_past_chunks", "one_id"):  # a run that chunk starts split
        assert counts["pieces"] > counts["distinct"]
    want = pallas_grads_padded(shapes, cores, ids, g)
    ref = jax_core_grads(shapes, jax_cores(cores), jnp.asarray(ids), jnp.asarray(g),
                         dedup=True)
    for a, b, c in zip(ours, want, ref):
        assert a.dtype == torch.float32
        assert_close(a.numpy(), b, rtol=1e-5)
        assert_close(a.numpy(), c, rtol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_empty_batch_plain_versions(ndim):
    """No ids: the plain lookup gives (0, D) rows and the plain gradients
    (both orders) zeros, as the card's wrappers do without a launch."""
    shapes, cores = case_for(ndim)
    tc = torch_cores(cores)
    ids = torch.zeros(0, dtype=torch.int32)
    assert tuple(tt_fwd(shapes, tc, ids).shape) == (0, shapes.embedding_dim)
    g = torch.zeros(0, shapes.embedding_dim)
    for grads in (tt_grads(shapes, tc, ids, g),
                  tt_kernels.tt_grads_grouped_plain(shapes, tc, ids, g)):
        for k, a in enumerate(grads):
            assert a.shape == shapes.core_shape(k) and not a.any()


def test_grouped_walk_counts():
    """The walk's pieces and segments on hand-made sorted ids: a piece is
    one id within one chunk, a segment one prefix (id // p_last) within one
    chunk."""
    shapes, _ = case_for(3)  # p_last 14
    sid = torch.tensor([3, 3, 5, 14, 14, 14, 15, 29, 29, 29], dtype=torch.int32)
    piece, segment = tt_kernels.grouped_walk(shapes, sid, chunk=4)
    assert piece.tolist() == [1, 0, 1, 1, 1, 0, 1, 1, 1, 0]
    assert segment.tolist() == [1, 0, 0, 1, 1, 0, 0, 1, 1, 0]
    counts = tt_kernels.grouped_counts(shapes, sid.flip(0), chunk=4)
    assert counts == {"ids": 10, "distinct": 5, "prefix_runs": 3, "pieces": 7,
                      "segments": 5}
    assert tt_kernels.grouped_counts(shapes, sid[:0])["pieces"] == 0


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_ttlookup_autograd_backward(ndim):
    """TTLookup's backward (tt_grads) on the CPU equals the Pallas grads."""
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(30 + ndim)
    ids = ids_with_duplicates(rng, shapes.num_embeddings, 256)
    g = rng.normal(size=(256, shapes.embedding_dim)).astype(np.float32)
    tc = [c.requires_grad_(True) for c in torch_cores(cores)]
    out = TTLookup.apply(shapes, torch.tensor(ids), *tc)
    out.backward(torch.tensor(g))
    want = tt_grads_pallas(shapes, jax_cores(cores), jnp.asarray(ids), jnp.asarray(g),
                           block=128, compute_dtype=jnp.float32)
    for c, b in zip(tc, want):
        assert_close(c.grad.numpy(), b, rtol=1e-4)


# ----------------------------------------------------------- B3 fused Adam
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_fused_adam_three_steps_match_pallas(ndim):
    """Three consecutive fused-Adam steps with moments carried, against the
    interpret-mode Pallas kernel (which the JAX suite never tests alone).
    Each step hands the Pallas kernel the port's current cores and
    moments, so every comparison is of one step from the same state."""
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(40 + ndim)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.01
    tc = torch_cores(cores)
    tm = [torch.zeros_like(c) for c in tc]
    tv = [torch.zeros_like(c) for c in tc]
    for t in (1, 2, 3):
        ids = ids_with_duplicates(rng, shapes.num_embeddings, 192)
        g = rng.normal(size=(192, shapes.embedding_dim)).astype(np.float32)
        scal = np.array([lr, 1 / (1 - b1 ** t), 1 / (1 - b2 ** t)], np.float32)
        state = [tuple(jnp.asarray(x.numpy()) for x in xs) for xs in (tc, tm, tv)]
        jc, jm, jv = tt_fused_adam_pallas(shapes, *state, jnp.asarray(ids),
                                          jnp.asarray(g), jnp.asarray(scal), b1, b2,
                                          eps, block=128, compute_dtype=jnp.float32)
        tt_fused_adam(shapes, tc, tm, tv, torch.tensor(ids), torch.tensor(g),
                      torch.tensor(scal), b1, b2, eps)
        for ours, theirs in ((tm, jm), (tv, jv)):
            for a, b in zip(ours, theirs):
                assert_close(a.numpy(), b, rtol=1e-4)
        # Adam divides m by sqrt(v): an element whose batch gradient nearly
        # cancels carries the f32 reordering error of that sum into a step
        # of size ~lr, so the cores get an absolute floor of 1e-3 * lr
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-3 * lr)


def test_adam_apply_is_optax_adam():
    """tt_adam_apply on given grads equals optax.adam's update."""
    import optax
    rng = np.random.default_rng(5)
    p = rng.normal(size=(7, 3, 2, 3)).astype(np.float32)
    tx = optax.adam(0.01)
    st = tx.init(jnp.asarray(p))
    tp, tm, tv = torch.tensor(p), torch.zeros(p.shape), torch.zeros(p.shape)
    jp = jnp.asarray(p)
    for t in (1, 2, 3):
        g = rng.normal(size=p.shape).astype(np.float32)
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
        scal = torch.tensor([0.01, 1 / (1 - 0.9 ** t), 1 / (1 - 0.999 ** t)])
        tt_adam_apply([tp], [tm], [tv], [torch.tensor(g)], scal, 0.9, 0.999, 1e-8)
        assert_close(tp.numpy(), jp, rtol=1e-5)


def test_wrappers_reject_mixed_devices_and_bad_input():
    shapes, cores = case_for(2)
    with pytest.raises(ValueError):
        tt_kernels._on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        TTShapes(10, 8, (2, 2, 2, 2, 2), (2, 2, 2, 1, 1), (2, 2, 2, 2))


def test_launch_counters_do_not_move_on_cpu():
    shapes, cores = case_for(3)
    tt_kernels.reset_launch_counts()
    tt_fwd(shapes, torch_cores(cores), torch.arange(10, dtype=torch.int32))
    counts = tt_kernels.launch_counts()
    assert {"tt_fwd", "tt_grads", "tt_adam_apply"} <= set(counts)
    assert set(counts.values()) == {0}

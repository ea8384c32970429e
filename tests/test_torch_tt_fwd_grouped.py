"""The prefix-grouped TT lookup (B1 ``tt_fwd`` and B4 ``tt_fwd_sr``) and the
one sort that a lookup's forward and backward share, against the JAX
package.

``tt_fwd_grouped_plain`` repeats the card kernel's walk in plain PyTorch:
the ids sorted, P_{T-2} once per prefix within a chunk, the last level
once per id within a chunk, the rows written through the permutation.  It
is held against the interpret-mode Pallas lookup and the JAX grouped lookup
over sorted ids (``tt_lookup_grouped_sorted``), and its stochastically
rounded form against ``tt_lookup_pallas_sr``.  Inputs are made with numpy
from a seed; JAX runs on the CPU.  The CUDA kernel itself is held against
these plain versions by tests/test_torch_cuda.py and chip_smoke.py on the
card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.ops.tt_lookup import tt_lookup_grouped_sorted
from falcon_ttdforgnns_tpu.ops.tt_pallas import tt_lookup_pallas_padded, tt_lookup_pallas_sr

from falcon_ttdforgnns_torch.ops import tt_init, tt_kernels
from falcon_ttdforgnns_torch.ops.tt_kernels import (TTLookup, TTLookupBF16, TTLookupBF16SR,
                                                    grouped_order, tt_fused_adagrad,
                                                    tt_fused_adam, tt_fused_sgd, tt_fwd,
                                                    tt_fwd_sr, tt_grads)
from falcon_ttdforgnns_torch.ops.tt_shapes import TTShapes

B = 384  # three Pallas blocks of 128
HOT = 150  # copies of the hot id: past two chunks of 64


def case_for(ndim):
    """The 2/3/4-core shapes of tests/test_pallas.py:57-69."""
    if ndim == 2:
        shapes = TTShapes(256, 64, (16, 16), (8, 8), (12,))
    elif ndim == 3:
        shapes = TTShapes(int(np.prod((10, 12, 14))), 60, (10, 12, 14), (3, 4, 5), (8, 8))
    else:
        shapes = TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))
    return shapes, tt_init.init_tt_cores(shapes, "normal", 0)


def draw(shapes, seed):
    """B unsorted ids: one hot id HOT times, ten ids four times each, runs
    of neighbouring ids of one prefix (id // p_last), the rest uniform."""
    rng = np.random.default_rng(seed)
    n, p_last = shapes.num_embeddings, shapes.p_last
    base = rng.integers(0, n // p_last, 3) * p_last
    same_prefix = (base[:, None] + np.arange(min(p_last, 5))[None, :]).ravel()
    ids = np.concatenate([np.full(HOT, n // 3), np.repeat(rng.integers(0, n, 10), 4),
                          same_prefix])
    ids = np.concatenate([ids, rng.integers(0, n, B - len(ids))])
    return rng.permutation(ids).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_rows(ndim):
    """(ids, cores, Pallas rows, JAX grouped rows) of one draw: the Pallas
    lookup in interpret mode with f32 compute, and tt_lookup_grouped_sorted
    on the sorted ids with its rows put back in the ids' order."""
    shapes, cores = case_for(ndim)
    ids = draw(shapes, 200 + ndim)
    jc = tuple(jnp.asarray(c) for c in cores)
    pallas = np.asarray(tt_lookup_pallas_padded(shapes, jc, jnp.asarray(ids), block=128,
                                                compute_dtype=jnp.float32))
    perm = np.argsort(ids, kind="stable")
    grouped = np.empty_like(pallas)
    grouped[perm] = np.asarray(tt_lookup_grouped_sorted(shapes, jc, jnp.asarray(ids[perm])))
    return ids, cores, pallas, grouped


def assert_close(got, want, rtol):
    """Elementwise rtol plus an absolute floor of rtol * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def bf16_equal_share(got, want) -> float:
    return float((bf16_bits(got) == bf16_bits(want)).mean())


def assert_bf16_close(got, want, min_equal):
    """tests/test_torch_tt_fused_updates.py's check: at least ``min_equal``
    of the bf16 values bit-identical, the rest one bf16 step apart or within
    1e-6 of the largest value."""
    off = np.abs(bf16_bits(got) - bf16_bits(want))
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    far = (off > 1) & (np.abs(g - w) > 1e-6 * np.abs(w).max())
    assert not far.any(), f"{far.sum()} values more than one bf16 step apart"
    assert (off == 0).mean() >= min_equal, (off == 0).mean()


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_grouped_lookup_matches_jax(ndim, chunk):
    """tt_fwd_grouped_plain against the Pallas lookup and the JAX grouped
    lookup: rel 1e-5 (f32 products of the same values, summed in bmm's
    order).  The draw holds what the walk must get right: repeats, a hot id
    across several chunks, and prefix changes both at chunk starts and
    inside chunks (asserted on the walk)."""
    shapes, _ = case_for(ndim)
    ids, cores, pallas, grouped = jax_rows(ndim)
    sid, _ = grouped_order(torch.tensor(ids))
    piece, segment = tt_kernels.grouped_walk(shapes, sid, chunk)
    start = torch.arange(B) % chunk == 0
    _, prefix_runs = tt_kernels.grouped_walk(shapes, sid, B)
    assert bool((prefix_runs & start).any())
    if chunk > 1:
        assert bool((prefix_runs & ~start).any())  # a prefix changes inside a chunk
        assert int(piece.sum()) < B  # some piece covers repeats
    hot_pieces = int((piece & (sid == int(np.bincount(ids).argmax()))).sum())
    assert hot_pieces == -(-HOT // chunk) or hot_pieces == -(-HOT // chunk) + 1
    ours = tt_kernels.tt_fwd_grouped_plain(shapes, [torch.tensor(c) for c in cores],
                                           torch.tensor(ids), chunk=chunk)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (B, shapes.embedding_dim)
    assert_close(ours.numpy(), pallas, rtol=1e-5)
    assert_close(ours.numpy(), grouped, rtol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_grouped_lookup_bf16_and_empty_batch(ndim):
    """The bf16 store of the grouped plain version is the f32 rows rounded
    to nearest even, within one bf16 step of the Pallas rows so rounded; an
    empty batch gives (0, D) in either store, f32, bf16 or SR."""
    shapes, _ = case_for(ndim)
    ids, cores, pallas, _ = jax_rows(ndim)
    tc = [torch.tensor(c) for c in cores]
    ours = tt_kernels.tt_fwd_grouped_plain(shapes, tc, torch.tensor(ids), torch.bfloat16, 3)
    assert ours.dtype == torch.bfloat16
    assert_bf16_close(ours, jnp.asarray(pallas).astype(jnp.bfloat16), min_equal=0.999)
    empty = torch.zeros(0, dtype=torch.int32)
    seed = torch.tensor(5, dtype=torch.int32)
    for out in (tt_kernels.tt_fwd_grouped_plain(shapes, tc, empty),
                tt_kernels.tt_fwd_grouped_plain(shapes, tc, empty, torch.bfloat16),
                tt_kernels.tt_fwd_sr_grouped_plain(shapes, tc, empty, seed)):
        assert tuple(out.shape) == (0, shapes.embedding_dim)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_grouped_sr_lookup_matches_pallas_sr(ndim):
    """The grouped SR plain version against tt_lookup_pallas_sr (interpret,
    block 128): >= 99.9% of the bf16 values bit-identical, the rest one step
    apart.  Each element is salted by its output row, so the HOT copies of
    the hot id, one computed row, are dithered apart; salting by the sorted
    position instead fails the same check by a wide margin."""
    shapes, _ = case_for(ndim)
    ids, cores, _, _ = jax_rows(ndim)
    tc = [torch.tensor(c) for c in cores]
    jc = tuple(jnp.asarray(c) for c in cores)
    for seed in (3, 2**31 - 5):
        ts = torch.tensor(seed, dtype=torch.int32)
        ref = tt_lookup_pallas_sr(shapes, jc, jnp.asarray(ids), jnp.int32(seed), block=128,
                                  compute_dtype=jnp.float32)
        for chunk in (1, 3, 64):
            ours = tt_kernels.tt_fwd_sr_grouped_plain(shapes, tc, torch.tensor(ids), ts, 128,
                                                      chunk)
            assert_bf16_close(ours, ref, min_equal=0.999)
        hot = ids == np.bincount(ids).argmax()
        assert len(np.unique(bf16_bits(ours)[hot], axis=0)) > 1  # the copies differ
        # the same rows salted by their sorted position, then put in place
        sid, perm = grouped_order(torch.tensor(ids))
        rows = tt_kernels.tt_fwd_grouped_plain(shapes, tc, sid)
        wrong = torch.empty_like(ours)
        wrong[perm] = tt_kernels.sr_cast_plain(rows, ts, 128)
        assert bf16_equal_share(wrong, ref) < 0.9


def small_batch(ndim, seed):
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(seed)
    ids = torch.tensor(draw(shapes, seed)[:200])
    g = torch.tensor(rng.normal(size=(200, shapes.embedding_dim)).astype(np.float32))
    return shapes, cores, ids, g


@pytest.mark.parametrize("ndim", [2, 4])
def test_order_threads_through_the_wrappers(ndim):
    """A given ``order`` gives what no order gives: the lookups, tt_grads
    and the three fused updates; each sorts nothing itself then."""
    shapes, cores, ids, g = small_batch(ndim, 300 + ndim)
    tc = [torch.tensor(c) for c in cores]
    order = grouped_order(ids)
    seed = torch.tensor(9, dtype=torch.int32)
    tt_kernels.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(tt_fwd(shapes, tc, ids, dtype, order=order),
                           tt_fwd(shapes, tc, ids, dtype))
    assert torch.equal(tt_fwd_sr(shapes, tc, ids, seed, order=order),
                       tt_fwd_sr(shapes, tc, ids, seed))
    for a, b in zip(tt_grads(shapes, tc, ids, g, order=order), tt_grads(shapes, tc, ids, g)):
        assert torch.equal(a, b)

    def run(order):
        cs = [c.clone() for c in tc]
        ms, vs = [torch.zeros_like(c) for c in cs], [torch.zeros_like(c) for c in cs]
        tt_fused_adam(shapes, cs, ms, vs, ids, g, torch.tensor([0.01, 10.0, 1000.0]),
                      order=order)
        tt_fused_sgd(shapes, cs, ids, g, 0.05, order=order)
        accs = [torch.ones(c.shape[0]) for c in cs]
        tt_fused_adagrad(shapes, cs, accs, ids, g, 0.05, 1e-8, rowwise=True, order=order)
        return cs + ms + vs + accs

    for a, b in zip(run(order), run(None)):
        assert torch.equal(a, b)
    assert tt_kernels.sort_count() == 0  # the plain versions take no order


def test_malformed_order_raises():
    shapes, cores, ids, g = small_batch(3, 310)
    tc = [torch.tensor(c) for c in cores]
    sid, perm = grouped_order(ids)
    for bad in ((sid,), (sid.long(), perm), (sid, perm.int()), (sid[:-1], perm),
                (sid, perm[:-1]), (sid, perm.reshape(-1, 1))):
        with pytest.raises((TypeError, ValueError)):
            tt_fwd(shapes, tc, ids, order=bad)
        with pytest.raises((TypeError, ValueError)):
            tt_grads(shapes, tc, ids, g, order=bad)
    with pytest.raises((TypeError, ValueError)):
        tt_fwd_sr(shapes, tc, ids, torch.tensor(1, dtype=torch.int32), order=(sid, perm[:3]))


@pytest.mark.parametrize("lookup", ["f32", "bf16", "bf16_sr"])
def test_lookup_sorts_once_for_forward_and_backward(lookup):
    """TTLookup, TTLookupBF16 and TTLookupBF16SR sort the ids once in the
    forward and hand that order to tt_grads in the backward: one sort, and
    the gradients of the plain version without an order."""
    shapes, cores, ids, g = small_batch(3, 320)
    leaf = [torch.tensor(c).requires_grad_(True) for c in cores]
    tt_kernels.reset_launch_counts()
    if lookup == "f32":
        out = TTLookup.apply(shapes, ids, *leaf)
    elif lookup == "bf16":
        out = TTLookupBF16.apply(shapes, ids, *leaf)
    else:
        out = TTLookupBF16SR.apply(shapes, ids, torch.tensor(4, dtype=torch.int32), *leaf)
    d = g.to(out.dtype)
    out.backward(d)
    assert tt_kernels.sort_count() == 1
    want = tt_kernels.tt_grads_plain(shapes, [torch.tensor(c) for c in cores], ids, d)
    for c, w in zip(leaf, want):
        assert torch.equal(c.grad, w)


@pytest.mark.parametrize("kw", [dict(), dict(bf16=True), dict(bf16=True, bf16_sr=True),
                                dict(tt_optimizer="sgd"), dict(tt_optimizer="adagrad")])
def test_fused_step_sorts_once(kw):
    """The --sparse step sorts its ids once, for the lookup and the fused
    core update alike."""
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=600, avg_degree=4, num_classes=3, feat_dim=8,
                                seed=0)
    tr = SageTrainer(ds, TrainConfig(batch_size=32, fanouts=(2, 2), hidden_dim=8,
                                     num_layers=2, tt_ranks=(4, 4), sparse=True, **kw),
                     device="cpu")
    before = [c.detach().clone() for c in tr.cores]
    for steps, b in enumerate(tr.loader, 1):
        tt_kernels.reset_launch_counts()
        loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
        assert np.isfinite(float(loss)) and tt_kernels.sort_count() == 1
        if steps == 2:
            break
    assert any(not torch.equal(a, c) for a, c in zip(before, tr.cores))

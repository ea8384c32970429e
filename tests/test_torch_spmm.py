"""The port's SpMM modules against the JAX package's, on the CPU.

* The tilers (``ops/spmm_tiled.py`` flat and uniform, ``ops/spmm_blocked.py``
  window tiles and the forward/backward pair of ``build_blocked_spmm``) are
  numpy copies: every array, chunk list and size must be bit-identical.
* The plain versions of the kernels (B7 and B8 ``spmm_tile_sum``, B9
  ``spmm_window_gather``) against the Pallas kernels in interpret mode.
  f32: rtol 1e-5 with an absolute floor of 1e-5 times the largest output
  (the one-hot matmul and index_add_ sum in other orders);
  hub rows (thousands of terms in one row) 1e-4 of the largest.  The bf16
  compute: both sides round h and w to bf16, so the products are exact and
  only the f32 sums differ: the same tolerance.  The window gather is one
  rounding per value on both sides: bit-identical.
* The blocked sum and ``apply_blocked_spmm``'s gradient (the transposed
  tiling) against the JAX custom VJP; ``headed_spmm`` forward and both
  gradients with one chunk and with several; the COO SpMMs of
  ``ops/segment.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.ops import segment as JS
from falcon_ttdforgnns_tpu.ops import spmm_blocked as JB
from falcon_ttdforgnns_tpu.ops import spmm_pallas as JP

from falcon_ttdforgnns_torch.ops import segment as S
from falcon_ttdforgnns_torch.ops import spmm_blocked as B
from falcon_ttdforgnns_torch.ops import spmm_tiled as P


def make_case(n, e, seed=0, weights=False, isolate_some=True, d=32):
    """tests/test_spmm_pallas.py's cases: dst-sorted edges, some rows with
    no in-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if isolate_some:
        dst = np.where(dst % 17 == 0, (dst + 1) % n, dst).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    w = rng.normal(size=e).astype(np.float32) if weights else None
    h = rng.normal(size=(n, d)).astype(np.float32)
    return h, src, dst, w


def hub_case():
    """Every edge into row 40: one block's run spans many tiles."""
    rng = np.random.default_rng(11)
    n, e = 64, 5000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.full(e, 40, np.int32)
    return rng.normal(size=(n, 16)).astype(np.float32), src, dst, None


def uniform_hub_case():
    rng = np.random.default_rng(21)
    n, e = 128, 4000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(np.where(rng.random(e) < 0.5, 77, rng.integers(0, n, e)).astype(np.int32))
    w = rng.normal(size=e).astype(np.float32)
    return rng.normal(size=(n, 32)).astype(np.float32), src, dst, w


# name: (case, tiler kwargs, tolerance on the largest output)
FLAT = {
    "500x4000": (lambda: make_case(500, 4000, seed=4500), dict(block_rows=32, tile_edges=64), 1e-5),
    "1000x500": (lambda: make_case(1000, 500, seed=1500), dict(block_rows=32, tile_edges=64), 1e-5),
    "64x64": (lambda: make_case(64, 64, seed=128), dict(block_rows=32, tile_edges=64), 1e-5),
    "weighted": (lambda: make_case(300, 2500, seed=3, weights=True),
                 dict(block_rows=32, tile_edges=128), 1e-5),
    "multi_chunk": (lambda: make_case(800, 6000, seed=7),
                    dict(block_rows=32, tile_edges=64, max_chunk_tiles=8), 1e-5),
    "hub": (hub_case, dict(block_rows=16, tile_edges=32), 1e-4),
}
UNIFORM = {
    "500x4000_tpc8": (lambda: make_case(500, 4000, seed=4501), 8, 32, 64, 1e-5),
    "1000x500_tpc4": (lambda: make_case(1000, 500, seed=1501), 4, 32, 64, 1e-5),
    "800x6000_tpc16_seams": (lambda: make_case(800, 6000, seed=6801), 16, 32, 64, 1e-5),
    "weighted_hub": (uniform_hub_case, 8, 16, 64, 1e-4),
}


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------------ tilers
@pytest.mark.parametrize("name", list(FLAT))
def test_flat_tiler_bit_identical(name):
    case, kw, _ = FLAT[name]
    h, src, dst, w = case()
    n = h.shape[0]
    ours = P.build_spmm_tiles(src, dst, n, edge_weight=w, **kw)
    ref = JP.build_spmm_tiles(src, dst, n, edge_weight=w, **kw)
    for f in ("src", "dstl", "w", "blk", "first"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.chunks == ref.chunks
    assert (ours.num_blocks, ours.block_rows, ours.tile_edges) == (
        ref.num_blocks, ref.block_rows, ref.tile_edges)


@pytest.mark.parametrize("name", list(UNIFORM))
def test_uniform_tiler_bit_identical(name):
    case, tpc, NR, E_t, _ = UNIFORM[name]
    h, src, dst, w = case()
    kw = dict(edge_weight=w, block_rows=NR, tile_edges=E_t, tiles_per_chunk=tpc)
    ours = P.build_spmm_tiles_uniform(src, dst, h.shape[0], **kw)
    ref = JP.build_spmm_tiles_uniform(src, dst, h.shape[0], **kw)
    for f in ("src", "dstl", "w", "blkl", "first", "blk0"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for f in ("num_blocks_padded", "blocks_per_chunk", "block_rows", "tile_edges"):
        assert getattr(ours, f) == getattr(ref, f)
    if name.endswith("seams"):
        assert ours.blk0.shape[0] > 3  # several chunks, so pad blocks meet the next chunk


@pytest.mark.parametrize("e,n", [(100, 1000), (20_000, 1000), (2_370_000, 169_343),
                                 (122_449_596, 2_449_029)])
def test_auto_tile_edges_matches(e, n):
    assert P.auto_tile_edges(e, n) == JP.auto_tile_edges(e, n)


def random_graph(n, e, seed=0, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        return ((rng.zipf(1.4, e) % n).astype(np.int64), (rng.zipf(1.4, e) % n).astype(np.int64))
    return rng.integers(0, n, e).astype(np.int64), rng.integers(0, n, e).astype(np.int64)


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("buckets", [1, 4])
def test_window_tiler_bit_identical(zipf, buckets):
    n, e = 3000, 20_000
    src, dst = random_graph(n, e, seed=1, zipf=zipf)
    w = np.random.default_rng(2).random(e).astype(np.float32)
    kw = dict(edge_weight=w, tile=256, dst_buckets=buckets, chunk_tiles=8)
    ours, ref = B.build_window_tiles(src, dst, n, **kw), JB.build_window_tiles(src, dst, n, **kw)
    for f in ("win", "idx", "dst", "w"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
        assert getattr(ours, f).dtype == getattr(ref, f).dtype
    assert (ours.tile, ours.num_nodes, ours.n_real_edges) == (ref.tile, ref.num_nodes,
                                                              ref.n_real_edges)
    for a, b in zip(B.chunk_tiles_host(ours, 8), JB.chunk_tiles_host(ref, 8)):
        np.testing.assert_array_equal(a, b)


def test_blocked_operator_tilings_bit_identical():
    n, e = 1500, 9_000
    src, dst = random_graph(n, e, seed=9)
    w = np.random.default_rng(10).random(e).astype(np.float32)
    kw = dict(edge_weight=w, tile=256, dst_buckets=4, chunk_tiles=8)
    ours = B.build_blocked_spmm(src, dst, n, **kw, device="cpu")
    ref = JB.build_blocked_spmm(src, dst, n, **kw)
    for side in ("fwd", "bwd"):
        for a, b in zip(getattr(ours, side), getattr(ref, side)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert B.default_blocked_tiling("cpu") == (256, 8)
    assert B.default_blocked_tiling("cuda") == (4096, 512)
    ts = B.build_window_tiles(src, dst, n, tile=256, chunk_tiles=8)
    with pytest.raises(ValueError):  # the tile count is no multiple of the chunk
        B.chunk_tiles_host(ts, ts.win.shape[0] + 1)


def test_blocked_operator_defaults_to_the_card():
    """build_blocked_spmm places its tilings on the card unless the caller
    asks for the CPU, as the trainers do: without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    src, dst = random_graph(300, 1000, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.build_blocked_spmm(src, dst, 300, tile=256, dst_buckets=4, chunk_tiles=8)


# -------------------------------------------------- plain tiled SpMMs (B7, B8)
@pytest.mark.parametrize("name", list(FLAT))
def test_tiled_plain_matches_pallas_interpret(name):
    case, kw, tol = FLAT[name]
    h, src, dst, w = case()
    n = h.shape[0]
    tiles = P.build_spmm_tiles(src, dst, n, edge_weight=w, **kw)
    ref = JP.spmm_sum_tiled(jnp.asarray(h), JP.build_spmm_tiles(src, dst, n, edge_weight=w,
                                                                **kw), n, interpret=True)
    out = P.spmm_sum_tiled(torch.tensor(h), tiles, n)
    assert out.dtype == torch.float32 and out.shape == (n, h.shape[1])
    close(out.numpy(), ref, tol)
    # and the exact sum
    want = np.zeros_like(h, dtype=np.float64)
    np.add.at(want, dst, h[src].astype(np.float64) * (1.0 if w is None else w[:, None]))
    close(out.numpy(), want, tol)


@pytest.mark.parametrize("name", list(UNIFORM))
def test_uniform_plain_matches_pallas_interpret(name):
    """Includes (800, 6000, 16), whose chunk seams show a wrong overwrite
    order (a pad block written after the real one zeroes its rows)."""
    case, tpc, NR, E_t, tol = UNIFORM[name]
    h, src, dst, w = case()
    n = h.shape[0]
    tu = P.build_spmm_tiles_uniform(src, dst, n, edge_weight=w, block_rows=NR,
                                    tile_edges=E_t, tiles_per_chunk=tpc)
    ref = JP.spmm_sum_tiled_uniform(
        jnp.asarray(h), jnp.asarray(tu.src), jnp.asarray(tu.dstl), jnp.asarray(tu.w),
        jnp.asarray(tu.blkl), jnp.asarray(tu.first), jnp.asarray(tu.blk0),
        tu.num_blocks_padded, tu.blocks_per_chunk, NR, E_t, n, interpret=True)
    out = P.spmm_sum_tiled_uniform(torch.tensor(h), t(tu.src), t(tu.dstl), t(tu.w),
                                   t(tu.blkl), t(tu.blk0), tu.num_blocks_padded,
                                   tu.blocks_per_chunk, NR, E_t, n)
    close(out.numpy(), ref, tol)


def seam_tiling(tu, n, rng):
    """A uniform tiling with real slots (w != 0, src and dstl in range) put
    in the pad tiles of every chunk but the last: tiles whose block the next
    chunk also covers.  The reference's scan writes the next chunk's rows
    over those blocks, so these slots must add nothing."""
    src, dstl, w = tu.src.copy(), tu.dstl.copy(), tu.w.copy()
    E_t, filled = tu.tile_edges, 0
    for c in range(tu.blk0.shape[0] - 1):
        for t in np.nonzero(tu.blk0[c] + tu.blkl[c] >= tu.blk0[c + 1])[0]:
            sl = slice(t * E_t, (t + 1) * E_t)
            src[c, sl] = rng.integers(0, n, E_t)
            dstl[c, sl] = rng.integers(0, tu.block_rows, E_t)
            w[c, sl] = rng.normal(size=E_t)
            filled += 1
    assert filled > 0
    return src, dstl, w


def test_uniform_seam_slots_are_overwritten_as_in_pallas():
    """B7's hostile case: w != 0 slots in blocks that the next chunk
    covers (a skewed in-degree, so chunks cover 1-6 blocks and pad the
    rest).  seg_mm_plain overwrites them as the reference's scan does."""
    rng = np.random.default_rng(6802)
    src = rng.integers(0, 800, 6000).astype(np.int32)
    dst = np.sort((rng.random(6000) ** 2 * 800).astype(np.int32))
    h = rng.normal(size=(800, 32)).astype(np.float32)
    tu = P.build_spmm_tiles_uniform(src, dst, 800, block_rows=32, tile_edges=64,
                                    tiles_per_chunk=16)
    s, dl, w = seam_tiling(tu, 800, rng)
    ref = JP.spmm_sum_tiled_uniform(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(dl), jnp.asarray(w), jnp.asarray(tu.blkl),
        jnp.asarray(tu.first), jnp.asarray(tu.blk0), tu.num_blocks_padded,
        tu.blocks_per_chunk, 32, 64, 800, interpret=True)
    args = (t(tu.blkl), t(tu.blk0), tu.num_blocks_padded, tu.blocks_per_chunk, 32, 64, 800)
    out = P.spmm_sum_tiled_uniform(torch.tensor(h), t(s), t(dl), t(w), *args)
    close(out.numpy(), ref, 1e-5)
    clean = P.spmm_sum_tiled_uniform(torch.tensor(h), t(tu.src), t(tu.dstl), t(tu.w), *args)
    close(out.numpy(), clean.numpy(), 1e-6)  # the seam slots changed nothing


def test_uniform_bf16_compute_matches_pallas_interpret():
    """compute_dtype bf16 on both sides: h and w rounded to bf16, products
    exact in f32, f32 sums.  Against the f32 result it is bf16-close."""
    h, src, dst, _ = make_case(800, 6000, seed=6801)
    w = np.random.default_rng(5).normal(size=src.shape[0]).astype(np.float32)
    tu = P.build_spmm_tiles_uniform(src, dst, 800, edge_weight=w, block_rows=32,
                                    tile_edges=64, tiles_per_chunk=16)
    ref = JP.spmm_sum_tiled_uniform(
        jnp.asarray(h), jnp.asarray(tu.src), jnp.asarray(tu.dstl), jnp.asarray(tu.w),
        jnp.asarray(tu.blkl), jnp.asarray(tu.first), jnp.asarray(tu.blk0),
        tu.num_blocks_padded, tu.blocks_per_chunk, 32, 64, 800,
        compute_dtype=jnp.bfloat16, interpret=True)
    args = (t(tu.src), t(tu.dstl), t(tu.w), t(tu.blkl), t(tu.blk0), tu.num_blocks_padded,
            tu.blocks_per_chunk, 32, 64, 800)
    out = P.spmm_sum_tiled_uniform(torch.tensor(h), *args, compute_dtype=torch.bfloat16)
    close(out.numpy(), ref, 1e-5)
    f32 = P.spmm_sum_tiled_uniform(torch.tensor(h), *args).numpy()
    assert not np.array_equal(out.numpy(), f32)
    close(out.numpy(), f32, 2e-2)
    # a bf16 h computes as its exact f32 upcast
    hb = torch.tensor(h).to(torch.bfloat16)
    np.testing.assert_array_equal(
        P.spmm_sum_tiled_uniform(hb, *args).numpy(),
        P.spmm_sum_tiled_uniform(hb.float(), *args).numpy())


@pytest.mark.parametrize("n,e", [(500, 4000), (1000, 500)])
def test_tile_partials_plain_matches_pallas_interpret(n, e):
    h, src, dst, _ = make_case(n, e, seed=n * 3 + e)
    tiles = P.build_spmm_tiles(src, dst, n, block_rows=32, tile_edges=64)
    ref = JP.spmm_sum_tile_partials(
        jnp.asarray(h), jnp.asarray(tiles.src), jnp.asarray(tiles.dstl), jnp.asarray(tiles.w),
        jnp.asarray(tiles.blk), tiles.num_blocks, 32, 64, n, interpret=True)
    out = P.spmm_sum_tile_partials(torch.tensor(h), t(tiles.src), t(tiles.dstl), t(tiles.w),
                                   t(tiles.blk), tiles.num_blocks, 32, 64, n)
    close(out.numpy(), ref, 1e-5)
    # the flat arrays route through the same plain version as the uniform one
    flat = P.spmm_sum_tiled_arrays(torch.tensor(h), t(tiles.src), t(tiles.dstl), t(tiles.w),
                                   t(tiles.blk), tiles.num_blocks, 32, 64, n)
    close(out.numpy(), flat.numpy(), 1e-5)


def hub_mix_case():
    """Random edges plus 700 into row 77: its block's run spans 11+ tiles
    of 64 slots, so many tiles (and warps of the kernel) meet on one row."""
    rng = np.random.default_rng(31)
    n, e, hub = 300, 2000, 700
    src = rng.integers(0, n, e + hub).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, e), np.full(hub, 77)]).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    w = rng.normal(size=e + hub).astype(np.float32)
    return rng.normal(size=(n, 24)).astype(np.float32), src[order], dst[order], w[order]


def pad_rows(tiles, n):
    """Points some real slots of the last block at rows past n: the
    reference sums them into pad rows of the block and slices them off."""
    dstl = tiles.dstl.copy()
    last = np.nonzero(tiles.blk == tiles.num_blocks - 1)[0]
    slots = np.concatenate([np.arange(t * tiles.tile_edges, (t + 1) * tiles.tile_edges)
                            for t in last])
    real = slots[tiles.w[slots] != 0][::2]
    first_pad = n - (tiles.num_blocks - 1) * tiles.block_rows
    assert real.size and first_pad < tiles.block_rows
    dstl[real] = first_pad + np.arange(real.size) % (tiles.block_rows - first_pad)
    return dstl


# name: (case, compute dtype, whether slots are moved to rows past n)
PARTIAL_CASES = {
    "d37": (lambda: make_case(500, 4000, seed=37, weights=True, d=37), "float32", False),
    "hub_many_tiles": (hub_mix_case, "float32", False),
    "pad_rows": (lambda: make_case(1000, 3000, seed=41, weights=True, d=8), "float32", True),
    "d37_bf16_compute": (lambda: make_case(500, 4000, seed=38, weights=True, d=37),
                         "bfloat16", False),
}


@pytest.mark.parametrize("name", list(PARTIAL_CASES))
def test_tile_partials_cases_match_pallas_interpret(name):
    """spmm_sum_tile_partials at the shapes the card's one-kernel design
    must keep: D=37 (no 16-byte loads), a hub row across many tiles, slots
    whose rows fall past num_nodes (dropped), and bf16 compute (h and w
    rounded to bf16 on both sides, products exact, f32 sums): 1e-5."""
    case, cdt, pads = PARTIAL_CASES[name]
    h, src, dst, w = case()
    n = h.shape[0]
    tiles = P.build_spmm_tiles(src, dst, n, edge_weight=w, block_rows=32, tile_edges=64)
    dstl = pad_rows(tiles, n) if pads else tiles.dstl
    if name == "hub_many_tiles":
        assert (tiles.blk == 77 // 32).sum() >= 11
    ref = JP.spmm_sum_tile_partials(
        jnp.asarray(h), jnp.asarray(tiles.src), jnp.asarray(dstl), jnp.asarray(tiles.w),
        jnp.asarray(tiles.blk), tiles.num_blocks, 32, 64, n,
        compute_dtype=getattr(jnp, cdt), interpret=True)
    out = P.spmm_sum_tile_partials(torch.tensor(h), t(tiles.src), t(dstl), t(tiles.w),
                                   t(tiles.blk), tiles.num_blocks, 32, 64, n,
                                   compute_dtype=getattr(torch, cdt))
    assert out.dtype == torch.float32 and out.shape == (n, h.shape[1])
    close(out.numpy(), ref, 1e-5)
    if pads:  # the moved slots are gone from every row below n
        kept = P.spmm_sum_tile_partials(torch.tensor(h), t(tiles.src), t(tiles.dstl),
                                        t(np.where(tiles.dstl != dstl, 0, tiles.w)),
                                        t(tiles.blk), tiles.num_blocks, 32, 64, n)
        close(out.numpy(), kept.numpy(), 1e-6)


def test_tiled_ignores_out_of_block_dstl_as_the_one_hot_does():
    h, src, dst, _ = make_case(200, 1500, seed=2)
    tiles = P.build_spmm_tiles(src, dst, 200, block_rows=32, tile_edges=64)
    dstl = tiles.dstl.copy()
    dstl[5] = 40  # past the 32-row block: no one-hot row matches
    ref = JP.spmm_sum_tiled_arrays(
        jnp.asarray(h), jnp.asarray(tiles.src), jnp.asarray(dstl), jnp.asarray(tiles.w),
        jnp.asarray(tiles.blk), jnp.asarray(tiles.first), tuple(tiles.chunks),
        tiles.num_blocks, 32, 64, 200, interpret=True)
    out = P.spmm_sum_tiled_arrays(torch.tensor(h), t(tiles.src), t(dstl), t(tiles.w),
                                  t(tiles.blk), tiles.num_blocks, 32, 64, 200)
    close(out.numpy(), ref, 1e-5)


def test_tiled_rejects_other_dtypes():
    h, src, dst, _ = make_case(100, 400, seed=1)
    tiles = P.build_spmm_tiles(src, dst, 100, block_rows=32, tile_edges=64)
    with pytest.raises(TypeError):
        P.spmm_sum_tiled(torch.tensor(h), tiles, 100, compute_dtype=torch.float16)
    with pytest.raises(TypeError):
        P.spmm_sum_tiled(torch.tensor(h).double(), tiles, 100)


# ------------------------------------------------------ blocked SpMM (B9)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_gather_plain_bit_identical_to_pallas(dtype):
    n, e, d, T = 1000, 6000, 16, 128
    src, dst = random_graph(n, e, seed=3)
    w = np.random.default_rng(4).normal(size=e).astype(np.float32)
    ts = B.build_window_tiles(src, dst, n, edge_weight=w, tile=T, dst_buckets=2, chunk_tiles=4)
    win2, idx2, _, w2 = B.chunk_tiles_host(ts, 4)
    h = np.random.default_rng(5).normal(size=(n, d)).astype(np.float32)
    hj = jnp.asarray(h).astype(dtype)
    half = T // 2
    n_half = -(-n // half) + 1
    h_pad = jnp.pad(hj, ((0, n_half * half - n), (0, 0)))
    ht = torch.tensor(h).to(getattr(torch, dtype))
    for c in range(win2.shape[0]):
        ref = JB._gather_msgs(h_pad, jnp.asarray(win2[c]), jnp.asarray(idx2[c]),
                              jnp.asarray(w2[c]), tile=T, interpret=True)
        got = B.window_gather(ht, t(win2[c]), t(idx2[c]), t(w2[c]), T)
        assert got.dtype == ht.dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("buckets", [1, 4])
def test_blocked_sum_matches_jax(zipf, buckets):
    n, e, d = 3000, 20_000, 16
    src, dst = random_graph(n, e, seed=1, zipf=zipf)
    w = np.random.default_rng(2).random(e).astype(np.float32)
    h = np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)
    kw = dict(edge_weight=w, tile=256, dst_buckets=buckets, chunk_tiles=8)
    ref = JB.spmm_sum_blocked(jnp.asarray(h), JB.build_window_tiles(src, dst, n, **kw),
                              chunk_tiles=8, interpret=True)
    got = B.spmm_sum_blocked(torch.tensor(h), B.build_window_tiles(src, dst, n, **kw), 8)
    close(got.numpy(), ref, 1e-5)


def test_blocked_self_loops_and_empty_rows():
    n = 257
    src = dst = np.arange(n, dtype=np.int64)
    h = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    ts = B.build_window_tiles(src, dst, n, tile=128, dst_buckets=2, chunk_tiles=2)
    np.testing.assert_array_equal(B.spmm_sum_blocked(torch.tensor(h), ts, 2).numpy(), h)


def test_apply_blocked_spmm_grad_matches_jax_vjp():
    """The backward runs the transposed tiling (src and dst swapped); the
    loss sum(sin(out) * out) as in tests/test_spmm_blocked.py."""
    n, e, d = 1500, 9_000, 8
    src, dst = random_graph(n, e, seed=9)
    w = np.random.default_rng(10).random(e).astype(np.float32)
    h0 = np.random.default_rng(11).normal(size=(n, d)).astype(np.float32)
    kw = dict(edge_weight=w, tile=256, dst_buckets=4, chunk_tiles=8)
    jop = JB.build_blocked_spmm(src, dst, n, **kw)

    def loss_j(h):
        out = JB.apply_blocked_spmm(h, jop)
        return jnp.sum(jnp.sin(out) * out)

    lj, gj = jax.value_and_grad(loss_j)(jnp.asarray(h0))
    op = B.build_blocked_spmm(src, dst, n, **kw, device="cpu")
    h = torch.tensor(h0, requires_grad=True)
    out = B.apply_blocked_spmm(h, op)
    loss = (torch.sin(out) * out).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-5)
    # the loss's derivative cos(out) * out + sin(out) multiplies the f32
    # reordering error of out (|out| up to ~15 here) by up to ~|out|
    close(h.grad.numpy(), gj, 1e-4)
    # against autograd through the plain COO sum
    h2 = torch.tensor(h0, requires_grad=True)
    out2 = S.spmm_sum(h2, torch.tensor(src), torch.tensor(dst), n, torch.tensor(w))
    (torch.sin(out2) * out2).sum().backward()
    close(h.grad.numpy(), h2.grad.numpy(), 1e-4)


# ------------------------------------------------------------- segment.py
def test_coo_spmms_match_jax():
    n, e, d = 400, 3000, 12
    src, dst = random_graph(n, e, seed=20)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    w = np.random.default_rng(21).normal(size=e).astype(np.float32)
    h = np.random.default_rng(22).normal(size=(n, d)).astype(np.float32)
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    hj, sj, dj, wj = map(jnp.asarray, (h, src, dst, w))
    ht, st, dt, wt = (torch.tensor(a) for a in (h, src.astype(np.int64), dst.astype(np.int64), w))
    close(S.spmm_sum(ht, st, dt, n, wt).numpy(), JS.spmm_sum(hj, sj, dj, n, wj), 1e-5)
    close(S.spmm_sum_chunked(ht, st, dt, n, wt, chunk=512).numpy(),
          JS.spmm_sum_chunked(hj, sj, dj, n, wj, chunk=512), 1e-5)
    close(S.spmm_mean(ht, st, dt, n, torch.tensor(deg), chunk=700).numpy(),
          JS.spmm_mean(hj, sj, dj, n, jnp.asarray(deg), chunk=700), 1e-5)
    close(S.gcn_norm_spmm(ht, st, dt, n, torch.tensor(deg), chunk=1000).numpy(),
          JS.gcn_norm_spmm(hj, sj, dj, n, jnp.asarray(deg), chunk=1000), 1e-5)


@pytest.mark.parametrize("chunk", [1 << 19, 700], ids=["one_chunk", "several_chunks"])
def test_headed_spmm_forward_and_grads_match_jax(chunk):
    n, e, H, d = 300, 2500, 3, 8
    src, dst = random_graph(n, e, seed=30)
    rng = np.random.default_rng(31)
    feat = rng.normal(size=(n, H, d)).astype(np.float32)
    w = rng.random((e, H)).astype(np.float32)
    g = rng.normal(size=(n, H, d)).astype(np.float32)
    sj, dj = jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32))

    def fj(f, ww):
        return jnp.sum(JS.headed_spmm(f, ww, sj, dj, n, chunk) * g)

    out_j = JS.headed_spmm(jnp.asarray(feat), jnp.asarray(w), sj, dj, n, chunk)
    df_j, dw_j = jax.grad(fj, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(w))
    ft = torch.tensor(feat, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = S.headed_spmm(ft, wt, torch.tensor(src), torch.tensor(dst), n, chunk)
    (out * torch.tensor(g)).sum().backward()
    close(out.detach().numpy(), out_j, 1e-5)
    close(ft.grad.numpy(), df_j, 1e-5)
    close(wt.grad.numpy(), dw_j, 1e-5)

"""The port's bf16 kernel I/O (B1/B2), stochastically rounded lookup (B4),
fused SGD (B5) and fused adagrad / rowwise adagrad (B6) against the JAX
package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs the Pallas kernels in interpret mode with f32 compute; the
port's side runs its plain versions, which is what its wrappers do for CPU
tensors.  The CUDA kernels themselves are held against the plain versions
by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.ops.tt_pallas import (_sr_cast, tt_fused_adagrad_pallas,
                                                 tt_fused_sgd_pallas, tt_grads_pallas,
                                                 tt_lookup_fused_bf16,
                                                 tt_lookup_fused_bf16_sr,
                                                 tt_lookup_pallas, tt_lookup_pallas_sr)

from falcon_ttdforgnns_torch.ops import tt_kernels
from falcon_ttdforgnns_torch.ops.tt_kernels import (sr_cast_plain, tt_fused_adagrad,
                                                    tt_fused_sgd, tt_fwd, tt_fwd_sr,
                                                    tt_grads, tt_lookup_fused_bf16
                                                    as torch_lookup_bf16,
                                                    tt_lookup_fused_bf16_sr
                                                    as torch_lookup_bf16_sr)
from falcon_ttdforgnns_torch.ops.tt_shapes import TTShapes
from falcon_ttdforgnns_torch.ops import tt_init


def case_for(ndim):
    """The 2/3/4-core shapes of tests/test_pallas.py:57-69."""
    if ndim == 2:
        shapes = TTShapes(256, 64, (16, 16), (8, 8), (12,))
    elif ndim == 3:
        shapes = TTShapes(int(np.prod((10, 12, 14))), 60, (10, 12, 14), (3, 4, 5), (8, 8))
    else:
        shapes = TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))
    return shapes, tt_init.init_tt_cores(shapes, "normal", 0)


def bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def assert_bf16_close(got, want, min_equal):
    """At least ``min_equal`` of the bf16 values bit-identical, the rest
    one bf16 step apart or within 1e-6 of the largest value: the two f32
    values before the store may differ by an f32 rounding of the chain's
    sums (another summation order), which moves the bf16 where it sits on a
    rounding boundary, and by more steps only for a near-cancelled sum far
    below the array's scale."""
    off = np.abs(bf16_bits(got) - bf16_bits(want))
    g, w = f64(got), f64(want)
    far = (off > 1) & (np.abs(g - w) > 1e-6 * np.abs(w).max())
    assert not far.any(), f"{far.sum()} values more than one bf16 step apart"
    assert (off == 0).mean() >= min_equal, (off == 0).mean()


def scaled_close(got, want, rtol):
    """Each array judged on its own scale: |got - want| <= rtol * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------- B4 SR cast
@pytest.mark.parametrize("block", [128, 1024])
def test_sr_cast_bit_identical_to_jax(block):
    """sr_cast_plain == tt_pallas.py:_sr_cast bit for bit, salted as
    _fwd_kernel_sr salts it (grid block pid, rows = features, cols = ids),
    on values spread over many binades and for seeds up to 2^31 - 1."""
    rng = np.random.default_rng(block)
    D, nb = 36, 3
    x = (rng.normal(size=(nb * block, D))
         * np.exp(3 * rng.normal(size=(nb * block, D)))).astype(np.float32)
    for seed in (0, 7, 123456789, 2**31 - 1):
        ours = sr_cast_plain(torch.tensor(x), torch.tensor(seed, dtype=torch.int32), block)
        assert ours.dtype == torch.bfloat16
        ref = []
        for pid in range(nb):
            salt = (jnp.uint32(seed) * jnp.uint32(0x9E3779B9)
                    + jnp.uint32(pid) * jnp.uint32(D * block))
            seg = jnp.asarray(x[pid * block:(pid + 1) * block].T)
            ref.append(np.asarray(_sr_cast(seg, salt, block, jnp.bfloat16)).T)
        np.testing.assert_array_equal(bf16_bits(ours), bf16_bits(np.concatenate(ref)))


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_sr_lookup_matches_pallas(ndim):
    """tt_fwd_sr against tt_lookup_pallas_sr(block=128): >= 99.9% of the
    bf16 values bit-identical, the rest one step apart."""
    shapes, cores = case_for(ndim)
    ids = np.random.default_rng(70 + ndim).integers(0, shapes.num_embeddings,
                                                    384).astype(np.int32)
    for seed in (3, 2**31 - 5):
        ours = tt_fwd_sr(shapes, [torch.tensor(c) for c in cores], torch.tensor(ids),
                         torch.tensor(seed, dtype=torch.int32), block=128)
        ref = tt_lookup_pallas_sr(shapes, tuple(jnp.asarray(c) for c in cores),
                                  jnp.asarray(ids), jnp.int32(seed), block=128,
                                  compute_dtype=jnp.float32)
        assert_bf16_close(ours, ref, min_equal=0.999)


# --------------------------------------------------------- B1/B2 bf16 I/O
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_bf16_lookup_matches_pallas(ndim):
    """tt_fwd(out_dtype=bf16) against tt_lookup_pallas(out_dtype=bf16):
    within one bf16 step (round to nearest even on both sides)."""
    shapes, cores = case_for(ndim)
    ids = np.random.default_rng(80 + ndim).integers(0, shapes.num_embeddings,
                                                    384).astype(np.int32)
    ours = tt_fwd(shapes, [torch.tensor(c) for c in cores], torch.tensor(ids),
                  torch.bfloat16)
    ref = tt_lookup_pallas(shapes, tuple(jnp.asarray(c) for c in cores),
                           jnp.asarray(ids), block=128, compute_dtype=jnp.float32,
                           out_dtype=jnp.bfloat16)
    assert ours.dtype == torch.bfloat16
    assert_bf16_close(ours, ref, min_equal=0.999)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_grads_of_bf16_dout_match_pallas(ndim):
    """tt_grads with a bf16 d_out against tt_grads_pallas with the same
    bf16 d_out: f32 gradients within 1e-5 of each core's largest value
    (both upcast d_out exactly; f32 sums in another order)."""
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(90 + ndim)
    ids = rng.integers(0, shapes.num_embeddings, 256).astype(np.int32)
    ids[128:144] = ids[:16]
    g = jnp.asarray(rng.normal(size=(256, shapes.embedding_dim)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    ours = tt_grads(shapes, [torch.tensor(c) for c in cores], torch.tensor(ids),
                    torch.tensor(bf16_bits(g).astype(np.int16)).view(torch.bfloat16))
    want = tt_grads_pallas(shapes, tuple(jnp.asarray(c) for c in cores),
                           jnp.asarray(ids), g, block=128, compute_dtype=jnp.float32)
    for a, b in zip(ours, want):
        assert a.dtype == torch.float32
        scaled_close(a.numpy(), b, 1e-5)


def test_bf16_lookups_autograd_match_jax():
    """TTLookupBF16 / TTLookupBF16SR against tt_lookup_fused_bf16 /
    tt_lookup_fused_bf16_sr under autograd: bf16 rows (SR bit-identical at
    block 1024, RN within a step), f32 core gradients of sum(rows^2)
    within 1e-3 of each core's largest (the bf16 cotangents 2 * rows may
    round apart where the rows did)."""
    shapes, cores = case_for(3)
    ids = np.random.default_rng(5).integers(0, shapes.num_embeddings, 300).astype(np.int32)
    jc = tuple(jnp.asarray(c) for c in cores)
    seed = 11
    for ours_fn, theirs_fn in (
            (lambda cs: torch_lookup_bf16(shapes, cs, torch.tensor(ids)),
             lambda cs: tt_lookup_fused_bf16(shapes, 1024, cs, jnp.asarray(ids))),
            (lambda cs: torch_lookup_bf16_sr(shapes, cs, torch.tensor(ids),
                                             torch.tensor(seed, dtype=torch.int32)),
             lambda cs: tt_lookup_fused_bf16_sr(shapes, 1024, cs, jnp.asarray(ids),
                                                jnp.int32(seed)))):
        leaf = [torch.tensor(c).requires_grad_(True) for c in cores]
        rows = ours_fn(leaf)
        assert rows.dtype == torch.bfloat16
        (rows.float() ** 2).sum().backward()
        assert_bf16_close(rows.detach(), theirs_fn(jc), min_equal=0.999)
        want = jax.grad(lambda cs: jnp.sum(theirs_fn(cs).astype(jnp.float32) ** 2))(jc)
        for c, w in zip(leaf, want):
            assert c.grad.dtype == torch.float32
            scaled_close(c.grad.numpy(), w, 1e-3)


# ------------------------------------------------------------ B5 fused SGD
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_fused_sgd_two_steps_match_pallas(ndim):
    """Two fused SGD steps, each side threading its own cores, against
    tt_fused_sgd_pallas: the cores within 1e-5 of their largest value
    (f32 gradient sums in another order, times lr)."""
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(100 + ndim)
    lr = 0.05
    tc = [torch.tensor(c) for c in cores]
    jc = tuple(jnp.asarray(c) for c in cores)
    for _ in range(2):
        ids = rng.integers(0, shapes.num_embeddings, 300).astype(np.int32)
        g = rng.normal(size=(300, shapes.embedding_dim)).astype(np.float32)
        jc = tt_fused_sgd_pallas(shapes, jc, jnp.asarray(ids), jnp.asarray(g), lr,
                                 block=128, compute_dtype=jnp.float32)
        tt_fused_sgd(shapes, tc, torch.tensor(ids), torch.tensor(g), lr)
        for a, b, c0 in zip(tc, jc, cores):
            scaled_close(a.numpy(), b, 1e-5)
            # the change itself; the Pallas kernel adds each grid block's
            # -lr * g into the core, rounding the core once per block
            change, want = a.numpy() - c0, np.asarray(b) - c0
            np.testing.assert_allclose(change, want, rtol=0, atol=1e-4 * np.abs(want).max()
                                       + 4 * np.finfo(np.float32).eps * np.abs(c0).max())


ODD_SHAPES = {  # core sizes that are no multiple of 4 (the kernel's scalar tail)
    2: TTShapes(35, 9, (5, 7), (3, 3), (3,)),                       # 45, 63 values
    4: TTShapes(225, 81, (3, 5, 3, 5), (3, 3, 3, 3), (3, 5, 3)),    # 27, 225, 135, 45
}


@pytest.mark.parametrize("ndim", sorted(ODD_SHAPES))
def test_fused_sgd_odd_core_sizes_match_pallas(ndim):
    """Fused SGD on cores whose sizes are no multiple of 4 against
    tt_fused_sgd_pallas in interpret mode, with the tolerances of the
    two-step test above; ids repeat, so duplicate ids accumulate."""
    shapes = ODD_SHAPES[ndim]
    cores = tt_init.init_tt_cores(shapes, "normal", 3)
    assert all(c.size % 4 for c in cores)
    rng = np.random.default_rng(120 + ndim)
    ids = rng.integers(0, shapes.num_embeddings, 300).astype(np.int32)
    g = rng.normal(size=(300, shapes.embedding_dim)).astype(np.float32)
    lr = 0.05
    jc = tt_fused_sgd_pallas(shapes, tuple(jnp.asarray(c) for c in cores), jnp.asarray(ids),
                             jnp.asarray(g), lr, block=128, compute_dtype=jnp.float32)
    tc = [torch.tensor(c) for c in cores]
    tt_fused_sgd(shapes, tc, torch.tensor(ids), torch.tensor(g), lr)
    for a, b, c0 in zip(tc, jc, cores):
        scaled_close(a.numpy(), b, 1e-5)
        change, want = a.numpy() - c0, np.asarray(b) - c0
        np.testing.assert_allclose(change, want, rtol=0, atol=1e-4 * np.abs(want).max()
                                   + 4 * np.finfo(np.float32).eps * np.abs(c0).max())


# -------------------------------------------------------- B6 fused adagrad
@pytest.mark.parametrize("ndim", [2, 3, 4])
@pytest.mark.parametrize("rowwise", [False, True])
def test_fused_adagrad_two_steps_match_pallas(ndim, rowwise):
    """Two fused adagrad steps from a nonzero accumulator, each side
    threading its own cores and accumulators, against
    tt_fused_adagrad_pallas: accumulators within 1e-4 of their largest
    value, cores rtol 1e-4 with the 1e-5 floor of tests/test_pallas.py's
    adagrad tests (normalised steps of size ~lr carry the f32 reordering
    of near-cancelled gradient elements)."""
    shapes, cores = case_for(ndim)
    rng = np.random.default_rng(110 + ndim)
    lr, eps = 0.05, (1e-8 if rowwise else 1e-10)
    accs = [np.abs(rng.normal(size=c.shape[:1] if rowwise else c.shape)).astype(np.float32)
            for c in cores]
    tc, ta = [torch.tensor(c) for c in cores], [torch.tensor(a) for a in accs]
    jc, ja = tuple(jnp.asarray(c) for c in cores), tuple(jnp.asarray(a) for a in accs)
    for _ in range(2):
        ids = rng.integers(0, shapes.num_embeddings, 300).astype(np.int32)
        g = rng.normal(size=(300, shapes.embedding_dim)).astype(np.float32)
        jc, ja = tt_fused_adagrad_pallas(shapes, jc, ja, jnp.asarray(ids),
                                         jnp.asarray(g), lr, eps, block=128,
                                         rowwise=rowwise, compute_dtype=jnp.float32)
        tt_fused_adagrad(shapes, tc, ta, torch.tensor(ids), torch.tensor(g), lr, eps,
                         rowwise)
        for a, b in zip(ta, ja):
            assert tuple(a.shape) == b.shape
            scaled_close(a.numpy(), b, 1e-4)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_new_wrappers_do_not_count_on_cpu():
    shapes, cores = case_for(2)
    tc = [torch.tensor(c) for c in cores]
    ids = torch.arange(10, dtype=torch.int32)
    tt_kernels.reset_launch_counts()
    tt_fwd(shapes, tc, ids, torch.bfloat16)
    tt_fwd_sr(shapes, tc, ids, torch.tensor(1, dtype=torch.int32))
    d = torch.ones(10, shapes.embedding_dim, dtype=torch.bfloat16)
    tt_fused_sgd(shapes, tc, ids, d, 0.1)
    tt_fused_adagrad(shapes, tc, [torch.zeros(c.shape[0]) for c in tc], ids, d, 0.1,
                     1e-8, rowwise=True)
    assert set(tt_kernels.launch_counts().values()) == {0}
    assert set(tt_kernels.launch_counts()) == set(tt_kernels.KERNELS)

"""Card-only tests of the port's CUDA kernels: each kernel against its
plain version, the wrappers' input checks, the lookups' autograd on the
card, the stochastic-rounding dither, and train steps that launch every
kernel.  Every test here carries the ``cuda`` marker and, without a CUDA
device, skips (the decision is made in a fixture, at run time).  This file
imports neither jax nor the JAX package, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from falcon_ttdforgnns_torch.ops import tt_init, tt_kernels
from falcon_ttdforgnns_torch.ops.tt_kernels import (TTLookup, TTLookupBF16SR,
                                                    tt_adagrad_apply, tt_adam_apply,
                                                    tt_fwd, tt_fwd_sr, tt_grads,
                                                    tt_sgd_apply)
from falcon_ttdforgnns_torch.ops.tt_shapes import TTShapes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(ndim, dev):
    shapes = {2: TTShapes(256, 64, (16, 16), (8, 8), (12,)),
              3: TTShapes(1680, 60, (10, 12, 14), (3, 4, 5), (8, 8)),
              4: TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))}[ndim]
    return shapes, [torch.tensor(c, device=dev)
                    for c in tt_init.init_tt_cores(shapes, "normal", 0)]


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_kernels_match_plain(cuda, ndim):
    """Tolerances on max|kernel - plain| / max|plain|: 1e-5 for the lookup
    and the Adam update (same f32 arithmetic, other FMA contraction), 1e-4
    for the gradients (atomics reorder the sums)."""
    shapes, cores = case(ndim, cuda)
    rng = np.random.default_rng(50 + ndim)
    ids = rng.integers(0, shapes.num_embeddings, 1001).astype(np.int32)
    ids[500:516] = ids[:16]
    ids = torch.tensor(ids, device=cuda)
    g = torch.tensor(rng.normal(size=(1001, shapes.embedding_dim)).astype(np.float32),
                     device=cuda)
    tt_kernels.reset_launch_counts()
    assert rel_err(tt_fwd(shapes, cores, ids), tt_kernels.tt_fwd_plain(shapes, cores, ids)) <= 1e-5
    for a, b in zip(tt_grads(shapes, cores, ids, g),
                    tt_kernels.tt_grads_plain(shapes, cores, ids, g)):
        assert rel_err(a, b) <= 1e-4
    grads = [torch.randn(c.shape, device=cuda) for c in cores]
    scal = torch.tensor([0.01, 10.0, 1000.0], device=cuda)

    def state():
        return ([c.clone() for c in cores], [torch.zeros_like(c) for c in cores],
                [torch.zeros_like(c) for c in cores])

    got, want = state(), state()
    tt_adam_apply(*got, grads, scal, 0.9, 0.999, 1e-8)
    tt_kernels.tt_adam_plain(*want, grads, scal, 0.9, 0.999, 1e-8)
    for k, old in enumerate(cores):
        # the cores by their change, so a missing update cannot pass
        assert rel_err(got[0][k] - old, want[0][k] - old) <= 1e-5
        assert rel_err(got[1][k], want[1][k]) <= 1e-5
        assert rel_err(got[2][k], want[2][k]) <= 1e-5
    counts = tt_kernels.launch_counts()
    assert {k: counts[k] for k in ("tt_fwd", "tt_grads", "tt_adam_apply")} == {
        "tt_fwd": 1, "tt_grads": 1, "tt_adam_apply": 1}


def grouped_case(kind, n, rng):
    """Unsorted ids for the grouped backward: long runs and duplicates among
    singles, one id's run past several 64-position chunks, one id over the
    whole batch, B = 1 and B = 0."""
    if kind == "runs_and_duplicates":
        ids = np.concatenate([np.repeat(rng.integers(0, n, 8), rng.integers(5, 60, 8)),
                              rng.integers(0, n, 700)])
    elif kind == "run_past_chunks":
        ids = np.concatenate([np.full(300, n // 3), rng.integers(0, n, 400)])
    elif kind == "one_id":
        ids = np.full(1000, n - 1)
    else:
        ids = np.arange({"b1": 1, "b0": 0}[kind]) + n // 2
    return rng.permutation(ids).astype(np.int32)


GROUPED_KINDS = ["runs_and_duplicates", "run_past_chunks", "one_id", "b1", "b0"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_tt_grads_grouped_kernel_matches_plain(cuda, ndim, dtype):
    """The sorted, prefix-grouped tt_grads against tt_grads_plain and against
    its own order in plain PyTorch (tt_grads_grouped_plain), f32 and bf16
    d_out (both sides upcast exactly): 1e-4 of each core's largest value,
    the atomics summing in run-to-run order.  B = 0 launches nothing and
    returns zeros."""
    shapes, cores = case(ndim, cuda)
    rng = np.random.default_rng(90 + ndim)
    tt_kernels.reset_launch_counts()
    for kind in GROUPED_KINDS:
        ids = torch.tensor(grouped_case(kind, shapes.num_embeddings, rng), device=cuda)
        g = torch.randn(ids.shape[0], shapes.embedding_dim, device=cuda).to(dtype)
        got = tt_grads(shapes, cores, ids, g)
        for want in (tt_kernels.tt_grads_plain(shapes, cores, ids, g),
                     tt_kernels.tt_grads_grouped_plain(shapes, cores, ids, g)):
            for a, b in zip(got, want):
                assert a.dtype == torch.float32 and a.shape == b.shape
                if kind == "b0":
                    assert not a.any() and not b.any()
                else:
                    assert rel_err(a, b) <= 1e-4, kind
    name = "tt_grads[bf16]" if dtype == torch.bfloat16 else "tt_grads"
    assert tt_kernels.launch_counts()[name] == len(GROUPED_KINDS) - 1


def bf16_ulps(got, want):
    """Distance in bf16 steps between two bf16 tensors of the same signs."""
    a = got.view(torch.int16).to(torch.int32)
    b = want.view(torch.int16).to(torch.int32)
    return (a - b).abs()


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_new_kernels_match_plain(cuda, ndim):
    """bf16 stores: the kernel's f32 value may be an ulp off the plain
    version's (other FMA order), so a bf16 may round one step apart — at
    most 0.1% of them.  tt_grads with a bf16 d_out: 1e-4 (atomics).  SGD
    and per-element adagrad repeat the plain arithmetic operation for
    operation (1e-6); rowwise adagrad sums g^2 in another order (1e-5)."""
    shapes, cores = case(ndim, cuda)
    rng = np.random.default_rng(60 + ndim)
    ids = torch.tensor(rng.integers(0, shapes.num_embeddings, 1001).astype(np.int32),
                       device=cuda)
    seed = torch.tensor(12345, dtype=torch.int32, device=cuda)
    tt_kernels.reset_launch_counts()
    for got, want in ((tt_fwd(shapes, cores, ids, torch.bfloat16),
                       tt_kernels.tt_fwd_plain(shapes, cores, ids, torch.bfloat16)),
                      (tt_fwd_sr(shapes, cores, ids, seed, 128),
                       tt_kernels.tt_fwd_sr_plain(shapes, cores, ids, seed, 128))):
        assert got.dtype == torch.bfloat16
        off = bf16_ulps(got, want)
        assert int(off.max()) <= 1 and float((off > 0).float().mean()) <= 1e-3
    g = torch.randn(1001, shapes.embedding_dim, device=cuda).to(torch.bfloat16)
    for a, b in zip(tt_grads(shapes, cores, ids, g),
                    tt_kernels.tt_grads_plain(shapes, cores, ids, g)):
        assert a.dtype == torch.float32 and rel_err(a, b) <= 1e-4
    grads = [torch.randn(c.shape, device=cuda) for c in cores]
    got, want = [c.clone() for c in cores], [c.clone() for c in cores]
    tt_sgd_apply(got, grads, 0.05)
    tt_kernels.tt_sgd_plain(want, grads, 0.05)
    for k, old in enumerate(cores):
        assert rel_err(got[k] - old, want[k] - old) <= 1e-6
    for rowwise in (False, True):
        def state():
            return ([c.clone() for c in cores],
                    [torch.rand(c.shape[:1] if rowwise else c.shape, device=cuda)
                     for c in cores])
        (gc, ga), (wc, wa) = state(), state()
        for w, g_ in zip(wa, ga):
            w.copy_(g_)
        tt_adagrad_apply(gc, ga, grads, 0.01, 1e-8 if rowwise else 1e-10, rowwise)
        tt_kernels.tt_adagrad_plain(wc, wa, grads, 0.01, 1e-8 if rowwise else 1e-10,
                                    rowwise)
        tol = 1e-5 if rowwise else 1e-6
        for k, old in enumerate(cores):
            assert rel_err(gc[k] - old, wc[k] - old) <= tol
            assert rel_err(ga[k], wa[k]) <= tol
    counts = tt_kernels.launch_counts()
    for name in ("tt_fwd[bf16]", "tt_fwd_sr", "tt_grads[bf16]", "tt_sgd_apply",
                 "tt_adagrad_apply", "tt_adagrad_apply[rowwise]"):
        assert counts[name] == 1, counts


ODD_SHAPES = {  # core sizes that are no multiple of 4: the kernel's scalar tail
    2: TTShapes(35, 9, (5, 7), (3, 3), (3,)),
    3: TTShapes(105, 27, (3, 5, 7), (3, 3, 3), (3, 5)),
    4: TTShapes(225, 81, (3, 5, 3, 5), (3, 3, 3, 3), (3, 5, 3)),
}


def misaligned(t):
    """A copy of t whose data starts 4 bytes past a 16-byte boundary."""
    skip = 4 // t.element_size()
    buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    out = buf[skip:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_sgd_apply_bit_identical_to_plain(cuda, ndim):
    """tt_sgd_apply repeats tt_sgd_plain's two roundings per value, so it is
    bit-identical: on the multiple-of-4 cores (float4 body), on cores of
    odd sizes (scalar tail), and on misaligned views of cores and
    gradients (the scalar loop throughout)."""
    rng = np.random.default_rng(70 + ndim)
    tt_kernels.reset_launch_counts()
    for shapes, view in ((case(ndim, cuda)[0], None), (ODD_SHAPES[ndim], None),
                         (case(ndim, cuda)[0], misaligned), (ODD_SHAPES[ndim], misaligned)):
        cores = [torch.tensor(c, device=cuda) for c in tt_init.init_tt_cores(shapes, "normal", 2)]
        grads = [torch.tensor(rng.normal(size=c.shape).astype(np.float32), device=cuda)
                 for c in cores]
        got = [c.clone() for c in cores]
        if view is not None:
            got, grads = [view(c) for c in got], [view(g) for g in grads]
        want = [c.clone() for c in cores]
        tt_sgd_apply(got, grads, 0.037)
        tt_kernels.tt_sgd_plain(want, grads, 0.037)
        for a, b, c in zip(got, want, cores):
            assert torch.equal(a, b) and not torch.equal(a, c)
    assert tt_kernels.launch_counts()["tt_sgd_apply"] == 4


def test_update_argument_cache_revalidates(cuda):
    """The launch arguments are kept per argument set; another shape or
    dtype at the same address, a non-contiguous view there, or a CPU
    tensor among CUDA ones validates anew and raises as a first call."""
    shapes, cores = case(3, cuda)
    grads = [torch.randn(c.shape, device=cuda) for c in cores]
    tt_kernels.reset_launch_counts()
    for _ in range(3):  # the second and third calls reuse the first's arguments
        want = [c.clone() for c in cores]
        tt_kernels.tt_sgd_plain(want, grads, 0.01)
        tt_sgd_apply(cores, grads, 0.01)
        assert all(torch.equal(a, b) for a, b in zip(cores, want))
    assert tt_kernels.launch_counts()["tt_sgd_apply"] == 3
    c0 = cores[0]
    with pytest.raises(ValueError):  # same address, another shape than its gradient
        tt_sgd_apply([c0.view(-1), *cores[1:]], grads, 0.01)
    with pytest.raises(TypeError):  # same address, another dtype
        tt_sgd_apply([c0.view(torch.int32), *cores[1:]], grads, 0.01)
    sq, one = torch.zeros(6, 6, device=cuda), torch.ones(6, 6, device=cuda)
    tt_sgd_apply([sq], [one], 1.0)
    assert torch.equal(sq, -one)
    with pytest.raises(ValueError):  # same address and shape, not contiguous
        tt_sgd_apply([sq.t()], [one], 1.0)
    with pytest.raises(ValueError):  # a CPU gradient among CUDA tensors
        tt_sgd_apply(cores, [grads[0].cpu(), *grads[1:]], 0.01)
    with pytest.raises(ValueError):  # a CPU core first, CUDA tensors after
        tt_sgd_apply([cores[0].cpu(), *cores[1:]], grads, 0.01)
    scal = torch.tensor([0.01, 10.0, 1000.0], device=cuda)
    ms, vs = [torch.zeros_like(c) for c in cores], [torch.zeros_like(c) for c in cores]
    tt_adam_apply(cores, ms, vs, grads, scal, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError):  # the moments' shapes are checked as before
        tt_adam_apply(cores, [m.view(-1) for m in ms], vs, grads, scal, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError):
        tt_adam_apply(cores, ms, vs, grads, scal.cpu(), 0.9, 0.999, 1e-8)
    assert tt_kernels.launch_counts()["tt_sgd_apply"] == 4
    assert tt_kernels.launch_counts()["tt_adam_apply"] == 1


@pytest.mark.parametrize("opt", ["sgd", "adam", "adagrad", "rowwise_adagrad"])
def test_update_argument_cache_takes_each_steps_gradients(cuda, opt):
    """The kept argument set covers the cores and the optimizer state; the
    gradients (and Adam's scal) are new tensors each step, at new addresses,
    and each call uses its own: every step equals the plain version's, and
    only the first call may validate an argument set (cores of an earlier
    test at the same addresses and shapes may have left it kept)."""
    shapes, cores = case(3, cuda)
    plain = [c.clone() for c in cores]
    state = {"adam": 2, "adagrad": 1, "rowwise_adagrad": 1}.get(opt, 0)
    rowwise = opt == "rowwise_adagrad"
    st = [[torch.zeros(c.shape[:1] if rowwise else c.shape, device=cuda) for c in cores]
          for _ in range(state)]
    st_plain = [[t.clone() for t in ts] for ts in st]
    tt_kernels.reset_launch_counts()
    keep = []
    for step in range(4):
        grads = [torch.randn(c.shape, device=cuda) for c in cores]
        keep.append(grads)  # held, so each step's gradients lie at new addresses
        if opt == "sgd":
            tt_sgd_apply(cores, grads, 0.01)
            tt_kernels.tt_sgd_plain(plain, grads, 0.01)
        elif opt == "adam":
            scal = torch.tensor([0.01, 1 / (1 - 0.9 ** (step + 1)),
                                 1 / (1 - 0.999 ** (step + 1))], device=cuda)
            tt_adam_apply(cores, *st, grads, scal, 0.9, 0.999, 1e-8)
            tt_kernels.tt_adam_plain(plain, *st_plain, grads, scal, 0.9, 0.999, 1e-8)
        else:
            tt_adagrad_apply(cores, *st, grads, 0.01, 1e-8, rowwise)
            tt_kernels.tt_adagrad_plain(plain, *st_plain, grads, 0.01, 1e-8, rowwise)
        for a, b in zip(cores, plain):
            if opt == "sgd":
                assert torch.equal(a, b)
            else:  # FMA contraction (Adam), the row sum's order (rowwise)
                assert rel_err(a, b) <= 1e-5
        if step == 0:
            first = tt_kernels.arg_cache_misses()
    assert len({g[0].data_ptr() for g in keep}) == 4
    assert first <= 1 and tt_kernels.arg_cache_misses() == first


def test_trainer_steps_reuse_the_update_arguments(cuda):
    """On the trainer's --sparse steps (fused Adam; tt_grads allocates the
    gradients, the trainer a new scal, every step) the update's argument
    set is validated on the first step at most."""
    tr = tiny_trainer(sparse=True)
    tt_kernels.reset_launch_counts()
    for step, b in zip(range(3), tr.loader):
        tr.train_step(b.seeds, b.layers, b.labels)
        if step == 0:
            first = tt_kernels.arg_cache_misses()
    assert tt_kernels.launch_counts()["tt_adam_apply"] == 3
    assert first <= 1 and tt_kernels.arg_cache_misses() == first


def test_sr_dither_varies_and_is_unbiased(cuda):
    """As tests/test_pallas.py's SR test: seeds give different dither, every
    SR output is within bf16 precision of the f32 rows, and the mean over
    16 seeds is at least as close to the f32 rows as one round-to-nearest
    cast; the backward is the seed-free bf16 one."""
    shapes, cores = case(3, cuda)
    ids = torch.randint(0, shapes.num_embeddings, (256,), dtype=torch.int32, device=cuda)
    f32 = tt_fwd(shapes, cores, ids).double()
    outs = [tt_fwd_sr(shapes, cores, ids, torch.tensor(s, dtype=torch.int32, device=cuda),
                      128).double() for s in range(16)]
    assert not torch.equal(outs[0], outs[1])
    for o in outs:
        torch.testing.assert_close(o, f32, rtol=2e-2, atol=2e-2)
    rn_err = (f32.float().to(torch.bfloat16).double() - f32).abs().mean()
    sr_err = (torch.stack(outs).mean(0) - f32).abs().mean()
    assert float(sr_err) <= float(rn_err) * 1.05
    leaf = [c.clone().requires_grad_(True) for c in cores]
    seed = torch.tensor(7, dtype=torch.int32, device=cuda)
    out = TTLookupBF16SR.apply(shapes, ids, seed, *leaf)
    g = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    out.backward(g)
    for c, w in zip(leaf, tt_kernels.tt_grads_plain(shapes, cores, ids, g)):
        assert c.grad.dtype == torch.float32 and rel_err(c.grad, w) <= 1e-4


def test_ttlookup_backward_on_card(cuda):
    shapes, cores = case(3, cuda)
    cores = [c.requires_grad_(True) for c in cores]
    ids = torch.randint(0, shapes.num_embeddings, (300,), dtype=torch.int32, device=cuda)
    g = torch.randn(300, shapes.embedding_dim, device=cuda)
    TTLookup.apply(shapes, ids, *cores).backward(g)
    want = tt_kernels.tt_grads_plain(shapes, [c.detach() for c in cores], ids, g)
    for c, w in zip(cores, want):
        assert rel_err(c.grad, w) <= 1e-4


def test_wrappers_raise_on_bad_input(cuda):
    shapes, cores = case(3, cuda)
    with pytest.raises(TypeError):
        tt_fwd(shapes, cores, torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        tt_fwd(shapes, cores, torch.zeros(4, dtype=torch.int32))  # ids on the CPU
    with pytest.raises(ValueError):
        tt_fwd(shapes, [c.transpose(0, 1) for c in cores],
               torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        tt_fwd(shapes, cores, torch.zeros(4, dtype=torch.int32, device=cuda),
               torch.float16)
    with pytest.raises(TypeError):
        tt_grads(shapes, cores, torch.zeros(4, dtype=torch.int32, device=cuda),
                 torch.zeros(4, shapes.embedding_dim, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):  # rowwise accumulators are (p,)
        tt_adagrad_apply(cores, [torch.zeros_like(c) for c in cores],
                         [torch.zeros_like(c) for c in cores], 0.1, 1e-8, rowwise=True)


def tiny_trainer(**kw):
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4,
                                feat_dim=16, seed=0)
    return SageTrainer(ds, TrainConfig(batch_size=64, fanouts=(3, 3), hidden_dim=16,
                                       num_layers=2, tt_ranks=(4, 4), **kw))


def test_train_step_launches_every_kernel(cuda):
    tr = tiny_trainer(sparse=True)
    b = next(iter(tr.loader))
    tt_kernels.reset_launch_counts()
    loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
    assert np.isfinite(float(loss))
    counts = tt_kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "tt_fwd": 1, "tt_grads": 1, "tt_adam_apply": 1}
    assert 0.0 <= tr.evaluate()["test_acc"] <= 1.0


@pytest.mark.parametrize("kw,launched", [
    (dict(bf16=True, bf16_sr=True), ("tt_fwd_sr", "tt_grads[bf16]", "tt_adam_apply")),
    (dict(bf16=True), ("tt_fwd[bf16]", "tt_grads[bf16]", "tt_adam_apply")),
    (dict(tt_optimizer="sgd"), ("tt_fwd", "tt_grads", "tt_sgd_apply")),
    (dict(tt_optimizer="adagrad"), ("tt_fwd", "tt_grads", "tt_adagrad_apply")),
    (dict(tt_optimizer="rowwise_adagrad"),
     ("tt_fwd", "tt_grads", "tt_adagrad_apply[rowwise]")),
])
def test_sparse_step_launches_its_kernels(cuda, kw, launched):
    tr = tiny_trainer(sparse=True, **kw)
    b = next(iter(tr.loader))
    before = [c.detach().clone() for c in tr.cores]
    tt_kernels.reset_launch_counts()
    loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
    assert np.isfinite(float(loss))
    counts = tt_kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == dict.fromkeys(launched, 1)
    assert any(not torch.equal(a, c) for a, c in zip(before, tr.cores))


def test_bf16_mean_is_f32_accumulated_on_card(cuda):
    """On the card, as on the CPU (tests/test_torch_sage.py), the bf16 mean
    equals mean(dtype=float32) cast back bit for bit: --bf16-mean-f32
    changes nothing in the port."""
    x = torch.randn(1024, 10, 15, 100, device=cuda).to(torch.bfloat16)
    assert torch.equal(x.mean(dim=2), x.mean(dim=2, dtype=torch.float32).to(torch.bfloat16))


# ------------------------------------------------------- SpMM kernels (B7-B9)
def spmm_case(n, e, seed, d=32):
    """Dst-sorted edges with weights, some rows without in-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst = np.where(dst % 17 == 0, (dst + 1) % n, dst).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    w = rng.normal(size=e).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32), src[order], dst[order], w


def spmm_close(got, want, tol):
    """max|kernel - plain| <= tol * max|plain|: the kernel sums each row in
    another order (FMA, runs per warp, shared-memory atomics)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("n,e,NR,E_t,tpc,d", [
    (800, 6000, 32, 64, 16, 32),     # chunk seams: pad blocks meet the next chunk
    (500, 4000, 32, 64, 8, 100),     # two column slabs, the second ragged
    (3000, 60000, 128, 2048, 4, 256),  # the trainer's tiling sizes
    (2000, 20000, 256, 1024, 4, 64),   # 64 KB of shared memory: the opt-in
])
def test_spmm_tiled_kernel_matches_plain(cuda, n, e, NR, E_t, tpc, d):
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    h, src, dst, w = spmm_case(n, e, n + e, d)
    tu = P.build_spmm_tiles_uniform(src, dst, n, edge_weight=w, block_rows=NR,
                                    tile_edges=E_t, tiles_per_chunk=tpc)
    args = [torch.as_tensor(a, device=cuda) for a in (tu.src, tu.dstl, tu.w, tu.blkl, tu.blk0)]
    meta = (tu.num_blocks_padded, tu.blocks_per_chunk, NR, E_t, n)
    ht = torch.tensor(h, device=cuda)
    P.reset_launch_counts()
    for hh, cd in ((ht, torch.float32), (ht.to(torch.bfloat16), torch.float32),
                   (ht, torch.bfloat16)):
        got = P.spmm_sum_tiled_uniform(hh, *args, *meta, compute_dtype=cd)
        want = P.seg_mm_plain(hh, *args, *meta[:4], compute_dtype=cd)[:n]
        spmm_close(got, want, 1e-5)
    assert P.launch_counts() == {"spmm_tiled": 2, "spmm_tiled[bf16]": 1,
                                 "spmm_tile_partials": 0, "spmm_tile_partials[bf16]": 0}
    exact = np.zeros((n, d))
    np.add.at(exact, dst, h[src].astype(np.float64) * w[:, None])
    spmm_close(P.spmm_sum_tiled_uniform(ht, *args, *meta).double().cpu(),
               torch.tensor(exact), 1e-5)
    tiles = P.build_spmm_tiles(src, dst, n, edge_weight=w, block_rows=NR, tile_edges=E_t)
    spmm_close(P.spmm_sum_tiled(ht, tiles, n), P.spmm_sum_tiled(ht.cpu(), tiles, n).to(cuda),
               1e-5)


def seam_case(d, seed, n=800, e=6000, NR=32, E_t=64, tpc=16):
    """A uniform tiling of skewed in-degrees (chunks cover 1-6 blocks and
    pad the rest) with real slots (w != 0) put in every pad tile whose block
    the next chunk covers: the reference's scan overwrites those blocks
    with the next chunk's rows, so these slots must add nothing."""
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort((rng.random(e) ** 2 * n).astype(np.int32))
    tu = P.build_spmm_tiles_uniform(src, dst, n, edge_weight=rng.normal(size=e).astype(np.float32),
                                    block_rows=NR, tile_edges=E_t, tiles_per_chunk=tpc)
    filled = 0
    for c in range(tu.blk0.shape[0] - 1):
        for t in np.nonzero(tu.blk0[c] + tu.blkl[c] >= tu.blk0[c + 1])[0]:
            sl = slice(t * E_t, (t + 1) * E_t)
            tu.src[c, sl] = rng.integers(0, n, E_t)
            tu.dstl[c, sl] = rng.integers(0, NR, E_t)
            tu.w[c, sl] = rng.normal(size=E_t)
            filled += 1
    assert filled > 0
    return rng.normal(size=(n, d)).astype(np.float32), tu


@pytest.mark.parametrize("d", [37, 64, 100, 256])
@pytest.mark.parametrize("variant", ["f32", "bf16_h", "bf16_compute", "misaligned_h"])
def test_spmm_tiled_seam_kernel_matches_plain(cuda, d, variant):
    """B7 on B8's engine against seg_mm_plain, the reference's scan: slots
    at the chunk seams that the next chunk overwrites add nothing, rows past
    num_nodes are dropped, and the call allocates the (num_nodes, D) output
    (and, for bf16 compute of an f32 h, h's bf16 copy).  1e-5 of the
    largest value: each row's sum meets across warps in atomic order."""
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    h, tu = seam_case(d, d + len(variant))
    num_nodes = h.shape[0] - 3
    ht = torch.tensor(h, device=cuda)
    if variant == "bf16_h":
        ht = ht.to(torch.bfloat16)
    elif variant == "misaligned_h":
        ht = misaligned(ht)
    cd = torch.bfloat16 if variant == "bf16_compute" else torch.float32
    args = [torch.as_tensor(a, device=cuda) for a in (tu.src, tu.dstl, tu.w, tu.blkl, tu.blk0)]
    meta = (tu.num_blocks_padded, tu.blocks_per_chunk, tu.block_rows, tu.tile_edges)
    P.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    got = P.spmm_sum_tiled_uniform(ht, *args, *meta, num_nodes, compute_dtype=cd)
    rise = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    torch.cuda.synchronize()
    counted = "spmm_tiled[bf16]" if cd == torch.bfloat16 else "spmm_tiled"
    assert {k: v for k, v in P.launch_counts().items() if v} == {counted: 1}
    assert got.shape == (num_nodes, d) and got.dtype == torch.float32
    copy = ht.numel() * 2 if cd == torch.bfloat16 and ht.dtype == torch.float32 else 0
    assert got.numel() * 4 + copy <= rise <= got.numel() * 4 + copy + 4096, rise
    spmm_close(got, P.seg_mm_plain(ht, *args, *meta, compute_dtype=cd)[:num_nodes], 1e-5)


def test_spmm_tile_partials_kernel_matches_plain(cuda):
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    n, e, NR, E_t = 1000, 9000, 32, 64
    h, src, dst, w = spmm_case(n, e, 7, 100)
    tiles = P.build_spmm_tiles(src, dst, n, edge_weight=w, block_rows=NR, tile_edges=E_t)
    args = [torch.as_tensor(a, device=cuda) for a in (tiles.src, tiles.dstl, tiles.w, tiles.blk)]
    ht = torch.tensor(h, device=cuda)
    P.reset_launch_counts()
    spmm_close(P.spmm_sum_tile_partials(ht, *args, tiles.num_blocks, NR, E_t, n),
               P.spmm_sum_tile_partials(ht.cpu(), *[a.cpu() for a in args], tiles.num_blocks,
                                        NR, E_t, n).to(cuda), 1e-5)
    spmm_close(P.tile_mm_plain(ht, args[0], args[1], args[2], NR, E_t),
               P.tile_mm_plain(ht.cpu(), *[a.cpu() for a in args[:3]], NR, E_t).to(cuda), 1e-5)
    assert P.launch_counts()["spmm_tile_partials"] == 1


def tile_sum_case(d, seed, n=1200, e=9000, NR=32, E_t=64):
    """The flat tiling of dst-sorted weighted edges with a hub row of
    in-degree 4 E_t + 5 (many tiles and warps meet on it), h of width d,
    and 40 real slots spoilt: src -1 or past h, dstl NR or -2.  Returns h,
    the tiling, the spoilt arrays (src, dstl, w, blk) for the kernel, and
    the same slots with w = 0 for the plain version: what the kernel must
    skip adds nothing."""
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    rng = np.random.default_rng(seed)
    hub = 4 * E_t + 5
    src = rng.integers(0, n, e + hub).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, e), np.full(hub, n // 2)]).astype(np.int32)
    w = rng.normal(size=e + hub).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    tiles = P.build_spmm_tiles(src[order], dst[order], n, edge_weight=w[order],
                               block_rows=NR, tile_edges=E_t)
    pick = rng.choice(np.nonzero(tiles.w != 0)[0], 40, replace=False)
    bad_src, bad_dstl, ok_w = tiles.src.copy(), tiles.dstl.copy(), tiles.w.copy()
    bad_src[pick[:10]], bad_src[pick[10:20]] = -1, n + 3
    bad_dstl[pick[20:30]], bad_dstl[pick[30:]] = NR, -2
    ok_w[pick] = 0
    h = rng.normal(size=(n, d)).astype(np.float32)
    return (h, tiles, (bad_src, bad_dstl, tiles.w, tiles.blk),
            (tiles.src, tiles.dstl, ok_w, tiles.blk))


@pytest.mark.parametrize("d", [37, 64, 100, 256])
@pytest.mark.parametrize("variant", ["f32", "bf16_h", "bf16_compute", "misaligned_h"])
def test_spmm_tile_sum_kernel_matches_plain(cuda, d, variant):
    """B8's one kernel against tile_partials_plain (per-tile partials, then
    their sum by block): 1e-5 of the largest value, each row's sum meeting
    across warps in atomic order.  D=37 and a misaligned h take one value
    per load, 64/100/256 16-byte loads (bf16 at 100: one value per load).
    Rows at or past num_nodes are dropped; the call allocates the
    (num_nodes, D) output and, for bf16 compute, h's bf16 copy: no
    partials."""
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    NR, E_t = 32, 64
    h, tiles, bad, ok = tile_sum_case(d, d + len(variant))
    num_nodes = h.shape[0] - 3  # the last rows' slots are dropped
    ht = torch.tensor(h, device=cuda)
    if variant == "bf16_h":
        ht = ht.to(torch.bfloat16)
    elif variant == "misaligned_h":
        ht = misaligned(ht)
    cd = torch.bfloat16 if variant == "bf16_compute" else torch.float32
    bad, ok = ([torch.as_tensor(a, device=cuda) for a in arrs] for arrs in (bad, ok))
    meta = (tiles.num_blocks, NR, E_t, num_nodes)
    P.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    got = P.spmm_sum_tile_partials(ht, *bad, *meta, compute_dtype=cd)
    rise = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    torch.cuda.synchronize()
    counted = "spmm_tile_partials[bf16]" if cd == torch.bfloat16 else "spmm_tile_partials"
    assert {k: v for k, v in P.launch_counts().items() if v} == {counted: 1}
    assert got.shape == (num_nodes, d) and got.dtype == torch.float32
    # bf16 compute of an f32 h also holds h's bf16 copy, which it gathers from
    copy = ht.numel() * 2 if cd == torch.bfloat16 and ht.dtype == torch.float32 else 0
    assert got.numel() * 4 + copy <= rise <= got.numel() * 4 + copy + 4096, rise
    spmm_close(got, P.tile_partials_plain(ht, *ok, *meta, compute_dtype=cd), 1e-5)
    hub = got[h.shape[0] // 2]
    assert float(hub.abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_gather_kernel_bit_identical(cuda, dtype):
    from falcon_ttdforgnns_torch.ops import spmm_blocked as B
    n, e, d, T = 3000, 40000, 100, 256
    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    ts = B.build_window_tiles(src, dst, n, edge_weight=w, tile=T, dst_buckets=4, chunk_tiles=8)
    h = torch.tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda).to(dtype)
    B.reset_launch_counts()
    for win, idx, _, ww in zip(*(torch.as_tensor(a, device=cuda)
                                 for a in B.chunk_tiles_host(ts, 8))):
        got = B.window_gather(h, win, idx, ww, T)
        want = B.window_gather_plain(h, win, idx, ww, T)
        assert got.dtype == dtype and torch.equal(got, want)
    assert B.launch_counts()["spmm_gather"] == ts.win.shape[0] // 8


def test_blocked_spmm_and_its_grad_on_card(cuda):
    """Forward and the transposed-tiling backward on the card against the
    same operator on the CPU (index_add_ adds in another order on the card:
    1e-5 of the largest)."""
    from falcon_ttdforgnns_torch.ops import spmm_blocked as B
    n, e, d = 2000, 30000, 64
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    h0 = rng.normal(size=(n, d)).astype(np.float32)
    grads = []
    for dev, tile, ct in ((cuda, 4096, 512), (torch.device("cpu"), 4096, 512)):
        op = B.build_blocked_spmm(src, dst, n, edge_weight=w, tile=tile, dst_buckets=16,
                                  chunk_tiles=ct, device=dev)
        h = torch.tensor(h0, device=dev, requires_grad=True)
        out = B.apply_blocked_spmm(h, op)
        (torch.sin(out) * out).sum().backward()
        grads.append((out.detach().cpu(), h.grad.cpu()))
    spmm_close(grads[0][0], grads[1][0], 1e-5)
    spmm_close(grads[0][1], grads[1][1], 1e-4)


def test_spmm_wrappers_raise_on_bad_input(cuda):
    from falcon_ttdforgnns_torch.ops import spmm_blocked as B
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    h, src, dst, w = spmm_case(300, 2000, 1)
    tu = P.build_spmm_tiles_uniform(src, dst, 300, edge_weight=w, block_rows=32,
                                    tile_edges=64, tiles_per_chunk=8)
    args = [torch.as_tensor(a, device=cuda) for a in (tu.src, tu.dstl, tu.w, tu.blkl, tu.blk0)]
    meta = (tu.num_blocks_padded, tu.blocks_per_chunk, 32, 64, 300)
    ht = torch.tensor(h, device=cuda)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        P.spmm_sum_tiled_uniform(ht, args[0].cpu(), *args[1:], *meta)
    with pytest.raises(TypeError):
        P.spmm_sum_tiled_uniform(ht, args[0].long(), *args[1:], *meta)
    assert args[4].shape[0] > 1
    with pytest.raises(ValueError):  # chunks out of block order (the seam rule needs it)
        P.spmm_sum_tiled_uniform(ht, *args[:4], args[4].flip(0).contiguous(), *meta)
    with pytest.raises(ValueError):
        B.window_gather(ht, torch.zeros(1, dtype=torch.int32, device=cuda),
                        torch.zeros(64, dtype=torch.int64, device=cuda),
                        torch.zeros(64, device=cuda), 64)


def test_blocked_gcn_step_launches_spmm_gather(cuda):
    """A full-graph GCN step with --spmm blocked on the card (B9 forward and
    backward per layer, the TT lookup's two kernels) against the same step
    on the CPU (plain versions, the CPU's smaller tiling): losses within
    1e-4, parameters within 3e-3 lr."""
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.ops import spmm_blocked as B
    from falcon_ttdforgnns_torch.train import FullGraphConfig, FullGraphTrainer
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16,
                                seed=0)
    cfg = FullGraphConfig(model="gcn", spmm="blocked", hidden_dim=16, num_layers=2,
                          tt_ranks=(4, 4), dropout=0.0, warmup_epochs=3)
    gpu, cpu = FullGraphTrainer(ds, cfg), FullGraphTrainer(ds, cfg, device="cpu")
    gpu.model.load_state_dict(cpu.model.state_dict())
    B.reset_launch_counts()
    tt_kernels.reset_launch_counts()
    for e in range(2):
        lg, lc = gpu.train_epoch(e)["loss"], cpu.train_epoch(e)["loss"]
        assert np.isfinite(lg) and lg == pytest.approx(lc, rel=1e-4)
    assert B.launch_counts()["spmm_gather"] >= 2 * 2 * cfg.num_layers
    counts = tt_kernels.launch_counts()
    assert counts["tt_fwd"] == 2 and counts["tt_grads"] == 2
    for a, b in zip(gpu.model.parameters(), cpu.model.parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 3 * 1e-3 * cfg.lr
    assert 0.0 <= gpu.evaluate()["test_acc"] <= 1.0


@pytest.mark.parametrize("spmm,kernel", [("pallas", "spmm_tiled"), ("blocked", "spmm_gather")])
def test_sage_evaluate_routes_launch_their_kernels(cuda, spmm, kernel):
    from falcon_ttdforgnns_torch.ops import spmm_blocked as B
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    base, tr = tiny_trainer(), tiny_trainer(spmm=spmm)
    tr.model.load_state_dict(base.model.state_dict())
    P.reset_launch_counts()
    B.reset_launch_counts()
    ours, xla = tr.evaluate(), base.evaluate()
    for k in ours:  # at most one near-tied argmax apart of 400 nodes
        assert abs(ours[k] - xla[k]) <= 1.0 / 400 + 1e-7
    counts = {**P.launch_counts(), **B.launch_counts()}
    assert counts[kernel] >= 2  # one per layer (blocked: one per chunk per layer)

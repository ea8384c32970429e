"""The port's forward-only f32 full-graph mean (``spmm_mean`` of an f32 ``h``
that needs no gradient, through ``csr_mean_f32``; on the CPU its plain
version) against the JAX package's f32 ``spmm_mean``, on the CPU.

Each row's sum runs in edge order from +0 and is divided by the degree (the
full in-degree count where none is given), so on the CPU it equals the
chunked ``index_add_`` path it replaced bit for bit, and JAX's f32 mean within
1e-6 (XLA's scatter may add in another order).  Cases: E past a small
``chunk`` in JAX, rows of degree 0 and past 256, unsorted edges, a given or
counted degree.  Then the paths around it: ``h`` that needs its gradient
still takes ``ChunkedSpmm`` (its gradient against JAX's), a graph's kept
row index gives the same bits as one built inside ``spmm_mean``, a
malformed edge list is refused once, when its index is built, and a trainer
builds its row index once for its life, with tracing on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.ops.segment import spmm_mean as jax_spmm_mean

from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.models.sage import SAGE
from falcon_ttdforgnns_torch.ops import segment
from falcon_ttdforgnns_torch.ops.segment import spmm_mean
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
from falcon_ttdforgnns_torch.utils import metrics

N = 600


def graph(seed: int = 0):
    """COO edges sorted by dst: row 0 with 300 in-edges, row 1 with 257,
    every fifth row without any, the last row with 40; (src, dst, deg)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 12, N)
    deg[::5] = 0
    deg[0], deg[1], deg[N - 1] = 300, 257, 40
    dst = np.repeat(np.arange(N), deg)
    src = rng.integers(0, N, dst.shape[0])
    return src, dst, deg.astype(np.float32)


def h_of(d: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(N, d)).astype(np.float32)


def chunked_mean(h, src, dst, deg):
    """The f32 path before the row index: the chunked index_add_ sum over
    the degree."""
    s = segment.spmm_sum_chunked(h, src, dst, N)
    if deg is None:
        deg = torch.bincount(dst, minlength=N)
    return s / torch.clamp(deg.to(torch.float32), min=1.0)[:, None]


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("chunk", [64, 1 << 22], ids=["chunked", "one-shot"])
@pytest.mark.parametrize("with_deg", [True, False], ids=["deg", "counted"])
def test_f32_mean_matches_jax_and_the_chunked_path(order, chunk, with_deg):
    src, dst, deg = graph()
    if order == "unsorted":
        perm = np.random.default_rng(3).permutation(src.shape[0])
        src, dst = src[perm], dst[perm]
    h = h_of(24)
    deg_t = torch.tensor(deg) if with_deg else None
    st, dt, ht = torch.tensor(src), torch.tensor(dst), torch.tensor(h)
    with torch.no_grad():
        got = spmm_mean(ht, st, dt, N, deg_t, chunk=chunk)
    want = jax_spmm_mean(jnp.asarray(h), jnp.asarray(src.astype(np.int32)),
                         jnp.asarray(dst.astype(np.int32)), N,
                         jnp.asarray(deg) if with_deg else None, chunk=chunk,
                         sorted_dst=order == "sorted")
    assert got.dtype == torch.float32 and got.shape == (N, 24)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # each row in edge order, as the chunked index_add_ added it on the CPU
    assert torch.equal(got, chunked_mean(ht, st, dt, deg_t))
    if not with_deg:  # the full count, no bf16 cap: rows 0 and 1 divide by 300 and 257
        ones = spmm_mean(torch.ones(N, 1), st, dt, N)
        assert float(ones[0, 0]) == 1.0 and float(ones[1, 0]) == 1.0


def test_plain_version_adds_each_row_in_edge_order():
    """Values whose f32 sum depends on the order: every row's sum equals
    numpy's unbuffered add in edge order, and zero-degree rows are +0."""
    src, dst, deg = graph(2)
    rng = np.random.default_rng(4)
    h = (rng.normal(size=(N, 300)) * 10.0 ** rng.integers(-4, 9, (N, 1))).astype(np.float32)
    acc = np.zeros((N, 300), np.float32)
    np.add.at(acc, dst, h[src])
    want = acc / np.maximum(deg, 1.0)[:, None]
    index = segment.edges_by_row(torch.tensor(src), torch.tensor(dst), N)
    got = segment.csr_mean_f32_plain(torch.tensor(h), index.src, index.indptr,
                                     torch.tensor(deg))
    np.testing.assert_array_equal(got.numpy(), want)
    empty = torch.tensor(deg) == 0
    assert not got[empty].view(torch.int32).any()  # +0, not -0
    assert torch.equal(index.indptr.diff(), torch.tensor(deg).long())


def test_gradient_path_stays_chunked(monkeypatch):
    """An f32 h that needs its gradient: no row index and no csr_mean_f32
    (both would raise here), and the gradient of sum(sin(mean)) matches
    JAX's."""
    src, dst, deg = graph(5)
    h = h_of(8, seed=6)

    def refuse(*args, **kwargs):
        raise AssertionError("the gradient path took the row index")

    monkeypatch.setattr(segment, "edges_by_row", refuse)
    monkeypatch.setattr(segment, "csr_mean_f32", refuse)
    ht = torch.tensor(h, requires_grad=True)
    out = spmm_mean(ht, torch.tensor(src), torch.tensor(dst), N, torch.tensor(deg), chunk=500)
    torch.sin(out).sum().backward()
    args = (jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)), N,
            jnp.asarray(deg))
    gj = jax.grad(lambda x: jnp.sin(jax_spmm_mean(x, *args, chunk=500)).sum())(jnp.asarray(h))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prebuilt_rows_give_the_same_bits(dtype):
    """A FullGraph's mean over its kept row index, twice, against
    spmm_mean, which builds its own index of the same unsorted edges."""
    src, dst, deg = graph(7)
    perm = np.random.default_rng(8).permutation(src.shape[0])
    st, dt = torch.tensor(src[perm]), torch.tensor(dst[perm])
    h = torch.tensor(h_of(12, seed=9)).to(dtype)
    for d in (torch.tensor(deg), None):
        kept = segment.FullGraph(st, dt, N, d)
        kept.index()
        inside = spmm_mean(h, st, dt, N, d)
        for _ in range(2):
            assert torch.equal(inside.view(torch.int16), kept.mean(h).view(torch.int16))


def test_wrapper_checks_and_runs_the_plain_version_on_the_cpu_only():
    src, dst, deg = graph()
    index = segment.edges_by_row(torch.tensor(src), torch.tensor(dst), N)
    h, d = torch.tensor(h_of(10)), torch.tensor(deg)
    segment.reset_launch_counts()
    assert torch.equal(segment.csr_mean_f32(h, index, d),
                       segment.csr_mean_f32_plain(h, index.src, index.indptr, d))
    assert segment.launch_counts() == {"segment_mean_bf16": 0, "csr_mean_f32": 0,
                                       "csr_mean_bf16": 0}
    with pytest.raises(ValueError):
        meta = segment.RowIndex(index.src.to("meta"), index.indptr.to("meta"), N)
        segment.csr_mean_f32(h.to("meta"), meta, d.to("meta"))
    with pytest.raises(TypeError):
        segment.csr_mean_f32(h.to(torch.bfloat16), index, d)
    with pytest.raises(ValueError, match="forward only"):
        segment.csr_mean_f32(h.requires_grad_(True), index, d)


def bad_edges(case):
    """The edges of graph() with one fault."""
    src, dst, _ = graph(11)
    src, dst = torch.tensor(src), torch.tensor(dst)
    if case == "dst out of range":
        dst[-1] = N
    elif case == "src out of range":
        src[7] = -1
    else:  # one source more than destinations: indptr would not span src
        src = torch.cat([src, src[:1]])
    return src, dst


@pytest.mark.parametrize("case", ["dst out of range", "src out of range",
                                  "indptr not spanning src"])
def test_a_malformed_index_is_refused_once_at_build(case, traced, monkeypatch):
    """edges_by_row refuses the edges in its one host read (none for a
    length mismatch, which the shapes show); a FullGraph of them refuses
    its first mean without gradient and runs no wrapper."""
    src, dst = bad_edges(case)
    monkeypatch.setattr(segment, "csr_mean_f32", None)  # never reached
    with pytest.raises(ValueError, match="edges_by_row"):
        segment.edges_by_row(src, dst, N)
    reads = 0 if case == "indptr not spanning src" else 1
    assert metrics.span_stats().get("spmm.host_reads", {}).get("count", 0) == reads
    with pytest.raises(ValueError, match="edges_by_row"):
        segment.FullGraph(src, dst, N).mean(torch.ones(N, 4))


@pytest.mark.parametrize("wrapper", ["segment_mean_bf16", "csr_mean_f32", "csr_gat"])
def test_a_wrapper_refuses_an_index_past_its_input_without_a_device_read(wrapper, traced):
    """An index whose sources may reach row N against an input of N rows:
    refused by the shared check on host integers, before any read or
    launch."""
    from falcon_ttdforgnns_torch.ops.attention import csr_gat
    src, dst, deg = graph(12)
    index = segment.edges_by_row(torch.tensor(src), torch.tensor(dst), N, N + 1)
    metrics.reset_spans()
    d, h = torch.tensor(deg), torch.tensor(h_of(8))
    calls = {"segment_mean_bf16": lambda: segment.segment_mean_bf16(h.bfloat16(), index, d),
             "csr_mean_f32": lambda: segment.csr_mean_f32(h, index, d),
             "csr_gat": lambda: csr_gat(h, torch.zeros(N, 2), torch.zeros(N, 2), index, 2,
                                        False)}
    with pytest.raises(ValueError, match=f"reach row {N}, past the {N} rows"):
        calls[wrapper]()
    assert metrics.span_stats() == {}


# ------------------------------------------- the row index, once a forward
TINY = dict(batch_size=64, fanouts=(3, 3, 3), hidden_dim=16, num_layers=3, tt_ranks=(4, 4),
            lr=0.003, seed=0)


@pytest.fixture(scope="module")
def dataset():
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16,
                                seed=0)
    return dataclasses.replace(ds, train_idx=ds.train_idx[:300])


@pytest.fixture
def traced():
    metrics.reset_spans()
    metrics.set_tracing(True)
    yield
    metrics.set_tracing(False)
    metrics.reset_spans()


def counting(monkeypatch, name):
    """Count the calls of segment's ``name`` that spmm_mean makes."""
    calls = []
    fn = getattr(segment, name)
    monkeypatch.setattr(segment, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def span_calls(*names):
    stats = metrics.span_stats()
    return [stats[n]["calls"] if n in stats else 0 for n in names]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_evaluate_builds_the_row_index_once(dataset, traced, monkeypatch, bf16):
    """Two evaluate() calls of three layers on one trainer: one spmm.rows in
    all, in the first call before its layers' spans, whose one host read the
    second call does not repeat; each mean through its CSR wrapper (bf16:
    layer 1's f32 mean, layer 2's bf16 one, and the mean of the last
    conv's product, 16 -> 4 classes padded to 8, in csr_mean_bf16; f32:
    three f32 ones, the last at the product's 4 columns)."""
    tr = SageTrainer(dataset, TrainConfig(**TINY, bf16=bf16), device="cpu")
    f32, bf = counting(monkeypatch, "csr_mean_f32"), counting(monkeypatch, "segment_mean_bf16")
    proj = counting(monkeypatch, "csr_mean_bf16")
    for call in (1, 2):
        tr.evaluate()
        assert span_calls("spmm.rows", "spmm.aggregate") == [1, 3 * call]
        assert metrics.span_stats()["spmm.host_reads"]["count"] == 1
    assert metrics.span_stats()["spmm.rows"]["parents"] == ["trainer.eval"]
    assert (len(f32), len(bf), len(proj)) == ((2, 2, 2) if bf16 else (6, 0, 0))


def test_layerwise_inference_builds_the_row_index_once(dataset, traced):
    """infer_full() then evaluate() on one trainer share its one row index,
    and infer_full() returns the logits that evaluate() scores, bit for
    bit, in f32 and bf16."""
    for bf16 in (False, True):
        metrics.reset_spans()
        tr = SageTrainer(dataset, TrainConfig(**TINY, bf16=bf16), device="cpu")
        logits, scored = tr.infer_full(), []
        inner = tr._accuracies
        tr._accuracies = lambda x: scored.append(x) or inner(x)
        tr.evaluate()
        assert logits.shape == (dataset.num_nodes, dataset.num_classes)
        assert logits.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert span_calls("spmm.rows", "spmm.aggregate") == [1, 6]
        assert torch.equal(logits, scored[0])


def test_full_neighbor_training_forward_builds_no_row_index(dataset, traced, monkeypatch):
    """Under grad the TT lookup's rows need their gradient: every layer
    takes the chunked scatter, and no row index is built."""
    tr = SageTrainer(dataset, TrainConfig(**TINY, use_sample=False), device="cpu")
    f32 = counting(monkeypatch, "csr_mean_f32")
    loss, _ = tr.full_neighbor_step(torch.arange(64))
    assert np.isfinite(float(loss))
    assert span_calls("spmm.rows", "spmm.aggregate") == [0, 3] and not f32


@pytest.mark.parametrize("classes", [16, 4])
def test_sage_forward_full_graph_matches_the_chunked_path(classes):
    """SAGE.forward_full_graph in f32 without gradient through the row
    index against the same model with every mean on the chunked scatter:
    the same bits where no conv narrows (each row's sum in edge order on
    both); where the last conv narrows (16 -> 4) its mean is taken after
    its product without gradient, the same linear map in another order:
    within f32 rounding of the chunked path."""
    src, dst, deg = graph(10)
    kw = dict(num_nodes=N, in_dim=16, hidden_dim=16, num_classes=classes, num_layers=3,
              tt_ranks=(2, 2), p_shapes=(6, 10, 10), q_shapes=(2, 2, 4), weight_dist="normal")
    model = SAGE(dropout=0.0, **kw)
    edges = segment.FullGraph(torch.tensor(src), torch.tensor(dst), N, torch.tensor(deg))
    with torch.no_grad():
        got = model.forward_full_graph(edges)
    params = [p.requires_grad for p in model.parameters()]
    assert all(params)
    want = model.forward_full_graph(edges)  # under grad: the chunked scatter
    assert want.requires_grad
    if classes == 16:
        assert torch.equal(got, want.detach())
    else:
        assert not torch.equal(got, want.detach())  # the last mean took the other order
        torch.testing.assert_close(got, want.detach(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))

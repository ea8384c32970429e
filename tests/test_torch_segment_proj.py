"""The mean of a narrowing conv's product, taken after the product
(``FullGraph.projected_mean``), on the CPU.

``csr_mean_bf16``'s plain version sums each row's in-edges in edge order in
f32 from +0 and rounds once to bf16; it is held bit for bit to
``csr_mean_f32_plain`` of the same rows in f32, cast to bf16: widths 8, 16
and 48, rows without in-edges, in-degrees over 256, rows across the
chunks of that scatter (its chunk set small here), values N(0, 1) and
N(0, 3e4^2).  Its wrapper runs that version on the CPU only, and refuses a
gradient, tensors on two devices and rows that are not whole 16-byte
loads.  Then the order: ``SAGE.forward_full_graph`` takes a narrowing
conv's mean after its product where no gradient is needed, and a 2-layer
SAGE (16 -> 32 -> 6 classes) stays within the stated tolerance of the JAX
package's ``forward_full_graph``: 2e-2 of max |JAX| in bf16 (and with the
last conv in f32), f32 rounding in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.models.sage import SAGE as JaxSAGE

from falcon_ttdforgnns_torch.convert import params_from_jax
from falcon_ttdforgnns_torch.models.sage import SAGE
from falcon_ttdforgnns_torch.nn.layers import SAGEConv
from falcon_ttdforgnns_torch.ops import segment
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


def index_of(seed: int = 0):
    src, dst, deg = graph(seed)
    return segment.edges_by_row(torch.tensor(src), torch.tensor(dst), N), torch.tensor(deg)


def product(d: int, scale: float = 1.0, seed: int = 1) -> torch.Tensor:
    """(N, d) bf16 rows of both signs, as a product's are."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(N, d, generator=g) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("scale", [1.0, 3e4], ids=["unit", "large"])
@pytest.mark.parametrize("d", [8, 16, 48])
def test_plain_sums_in_f32_and_rounds_once(monkeypatch, d, scale):
    index, deg = index_of()
    monkeypatch.setattr(segment, "SPMM_CHUNK", 64)
    starts = index.indptr.tolist()
    assert any(starts[v] // 64 != (starts[v + 1] - 1) // 64
               for v in range(N) if starts[v + 1] - starts[v] > 1)
    p = product(d, scale)
    got = segment.csr_mean_bf16_plain(p, index.src, index.indptr, deg)
    want = segment.csr_mean_f32_plain(p.float(), index.src, index.indptr, deg)
    assert got.dtype == torch.bfloat16 and got.shape == (N, d)
    assert torch.equal(got.view(torch.int16), want.to(torch.bfloat16).view(torch.int16))
    assert not got[5::5].view(torch.int16).any()  # no in-edges: +0


def test_plain_divides_by_the_degree_it_is_given():
    """In-degrees 300 and 257 divide as given, not rounded to bf16 (257
    would round to 256); a degree of 0 divides by 1."""
    index, deg = index_of()
    p = torch.ones((N, 8), dtype=torch.bfloat16)
    got = segment.csr_mean_bf16_plain(p, index.src, index.indptr, deg * 2)
    assert float(got[0, 0]) == 0.5 and float(got[1, 0]) == 0.5
    sums = segment.csr_mean_bf16_plain(p, index.src, index.indptr, torch.zeros(N))
    assert float(sums[1, 0]) == torch.tensor(257.0).to(torch.bfloat16).item()


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    index, deg = index_of()
    p = product(48)
    segment.reset_launch_counts()
    assert torch.equal(segment.csr_mean_bf16(p, index, deg),
                       segment.csr_mean_bf16_plain(p, index.src, index.indptr, deg))
    assert segment.launch_counts() == dict.fromkeys(segment.KERNELS, 0)


@pytest.mark.parametrize("fault", ["gradient", "devices", "width", "dtype"])
def test_wrapper_refuses(fault):
    index, deg = index_of()
    p = product(48)
    err, match = ValueError, None
    if fault == "gradient":
        p, match = p.requires_grad_(True), "forward only"
    elif fault == "devices":
        index = segment.RowIndex(index.src.to("meta"), index.indptr.to("meta"), N)
        match = "one CUDA device or on the CPU"
    elif fault == "width":
        p, match = product(12), "multiple of 8"
    else:
        p, err = p.float(), TypeError
    with pytest.raises(err, match=match):
        segment.csr_mean_bf16(p, index, deg)


def test_the_graph_routes_a_product_by_its_dtype():
    """projected_mean: a bf16 product through csr_mean_bf16, an f32 one
    through csr_mean_f32 at the product's width; a bf16 input's counted
    degree stops at 256 as in mean()."""
    src, dst, _ = graph()
    edges = segment.FullGraph(torch.tensor(src), torch.tensor(dst), N)
    p = product(8)
    got = edges.projected_mean(p, torch.bfloat16)
    counted = torch.clamp(edges.index().indptr.diff(), max=segment.BF16_COUNT_MAX)
    assert torch.equal(got, segment.csr_mean_bf16_plain(p, edges.index().src,
                                                        edges.index().indptr, counted))
    f32 = edges.projected_mean(p.float(), torch.float32)
    assert f32.dtype == torch.float32
    assert torch.equal(f32, segment.csr_mean_f32_plain(p.float(), edges.index().src,
                                                       edges.index().indptr,
                                                       edges.index().indptr.diff()))


@pytest.mark.parametrize("dtype,ins,outs,width", [
    (torch.bfloat16, 256, 47, 48), (torch.float32, 256, 47, 48), (None, 32, 6, 8),
    (torch.bfloat16, 100, 256, 0), (torch.bfloat16, 256, 256, 0), (torch.bfloat16, 48, 47, 0),
], ids=["bf16-47", "f32-47", "promoted-6", "widens", "square", "pads-to-input"])
def test_the_mean_goes_after_the_product_where_it_narrows(dtype, ins, outs, width):
    """The padded product's width where it is narrower than the input, else
    0; under grad always 0 (the mean must keep its gradient)."""
    conv = SAGEConv(ins, outs, dtype=dtype)
    h = torch.zeros(4, ins, dtype=torch.bfloat16 if dtype is None else torch.float32)
    with torch.no_grad():
        assert SAGE._product_width(conv, h) == width
    assert SAGE._product_width(conv, h) == 0
    if width:
        with torch.no_grad():
            p = conv.neigh_product(h + 1, width)
        assert p.shape == (4, width) and not p[:, outs:].any()


def span_calls(*names):
    stats = metrics.span_stats()
    return [stats[n]["calls"] if n in stats else 0 for n in names]


@pytest.mark.parametrize("mode", ["bf16", "f32_head", "f32"])
def test_sage_full_graph_takes_the_last_mean_after_its_product(monkeypatch, mode):
    """A 2-layer SAGE, 16 -> 32 -> 6 classes (the last conv padded to 8),
    against JAX's forward_full_graph, which takes every mean first: within
    2e-2 of max |JAX| under bf16 (the last conv bf16 or f32), within f32
    rounding in f32.  Layer 2 runs its product, its mean and its finish:
    three tower.conv spans and two spmm.aggregate spans in all."""
    kw = dict(num_nodes=N, in_dim=16, hidden_dim=32, num_classes=6, num_layers=2,
              tt_ranks=(2, 2), p_shapes=(6, 10, 10), q_shapes=(2, 2, 4),
              weight_dist="normal", bf16=mode != "f32", bf16_f32_head=mode == "f32_head")
    jm = JaxSAGE(dropout=0.0, **kw)
    src, dst, deg = graph(4)
    args = (jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)),
            jnp.asarray(deg))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), *args,
                                              method=JaxSAGE.forward_full_graph)["params"])
    rng = np.random.default_rng(5)
    for k in range(3):  # small dyadic cores: both lookups exact
        c = params["embed"][f"tt_core_{k}"]
        params["embed"][f"tt_core_{k}"] = (rng.integers(-4, 5, c.shape) / 4).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, *args, False, chunk=256,
                               method=JaxSAGE.forward_full_graph).astype(jnp.float32))
    ours = SAGE(dropout=0.0, **kw)
    ours.load_state_dict(params_from_jax(params), strict=True)
    calls = {name: [] for name in ("csr_mean_bf16", "csr_mean_f32", "segment_mean_bf16")}
    for name, seen in calls.items():
        fn = getattr(segment, name)
        monkeypatch.setattr(segment, name,
                            lambda *a, fn=fn, seen=seen, **k: seen.append(1) or fn(*a, **k))
    metrics.reset_spans()
    metrics.set_tracing(True)
    try:
        with torch.no_grad():
            got = ours.forward_full_graph(segment.FullGraph(
                torch.tensor(src), torch.tensor(dst), N, torch.tensor(deg), 256))
        assert span_calls("tower.conv", "spmm.aggregate") == [3, 2]
    finally:
        metrics.set_tracing(False)
        metrics.reset_spans()
    assert {k: len(v) for k, v in calls.items()} == {
        "bf16": {"csr_mean_bf16": 1, "csr_mean_f32": 1, "segment_mean_bf16": 0},
        "f32_head": {"csr_mean_bf16": 0, "csr_mean_f32": 2, "segment_mean_bf16": 0},
        "f32": {"csr_mean_bf16": 0, "csr_mean_f32": 2, "segment_mean_bf16": 0}}[mode]
    assert got.shape == (N, 6)
    assert got.dtype == (torch.float32 if mode != "bf16" else torch.bfloat16)
    rel = 1e-5 if mode == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=rel * np.abs(want).max())

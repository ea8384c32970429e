"""The port's bf16 full-graph mean (``spmm_mean`` of a bf16 ``h``, through
``segment_mean_bf16``; on the CPU its plain version) against the JAX
package's ``spmm_mean`` bit for bit: XLA's segment sum adds each row's
messages in edge order with a bf16 rounding after every add, also across
its edge chunks, then divides by the degree cast to bf16 (a bf16 count of
ones, which stops at 256, where none is given).  Cases: E past a small
``chunk`` in both packages, rows across a chunk boundary and the last row,
in-degrees over 256, zero-degree rows, unsorted edges; then the bf16
``SAGE.forward_full_graph`` and one layer of ``spmm_mean`` and
``apply_conv`` against JAX's ``forward_full_graph`` and ``forward_full``,
bit for bit where the convs are exact (identity weights) and within bf16
tolerance with random weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.models.sage import SAGE as JaxSAGE
from falcon_ttdforgnns_tpu.ops.segment import spmm_mean as jax_spmm_mean

from falcon_ttdforgnns_torch.convert import params_from_jax
from falcon_ttdforgnns_torch.models.sage import SAGE
from falcon_ttdforgnns_torch.ops import segment
from falcon_ttdforgnns_torch.ops.segment import spmm_mean

N = 600


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def graph(seed: int = 0):
    """COO edges sorted by dst: row 0 with 300 in-edges, row 1 with 257,
    every fifth row without any, the last row with 40; (src, dst, deg)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 12, N)
    deg[::5] = 0
    deg[0], deg[1], deg[N - 1] = 300, 257, 40
    dst = np.repeat(np.arange(N), deg).astype(np.int32)
    src = rng.integers(0, N, dst.shape[0]).astype(np.int32)
    return src, dst, deg.astype(np.float32)


def h_of(d: int, scale: float, seed: int = 1) -> np.ndarray:
    """f32 values on the bf16 grid."""
    x = np.random.default_rng(seed).normal(size=(N, d)) * scale
    return np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def both(h, src, dst, deg, chunk, sorted_dst=True):
    """JAX's and the port's bf16 spmm_mean of the same inputs."""
    want = jax_spmm_mean(jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(src),
                         jnp.asarray(dst), N, None if deg is None else jnp.asarray(deg),
                         chunk=chunk, sorted_dst=sorted_dst)
    got = spmm_mean(torch.tensor(h).to(torch.bfloat16), torch.tensor(src.astype(np.int64)),
                    torch.tensor(dst.astype(np.int64)), N,
                    None if deg is None else torch.tensor(deg), chunk=chunk)
    return got, want


@pytest.mark.parametrize("chunk", [64, 1 << 22], ids=["chunked", "one-shot"])
@pytest.mark.parametrize("with_deg", [True, False], ids=["deg", "counted"])
@pytest.mark.parametrize("d,scale", [(24, 1.0), (7, 1.0), (24, 3e4)],
                         ids=["d24", "d7", "large"])
def test_bf16_mean_is_jax_bit_for_bit(chunk, with_deg, d, scale):
    src, dst, deg = graph()
    E = src.shape[0]
    if chunk < E:  # rows that span a chunk boundary, and the last row in the last chunk
        starts = np.r_[0, np.cumsum(deg.astype(np.int64))]
        assert any(starts[v] // chunk != (starts[v + 1] - 1) // chunk
                   for v in range(N) if deg[v] > 1)
        assert E % chunk and deg[N - 1] > 0
    got, want = both(h_of(d, scale), src, dst, deg if with_deg else None, chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (N, d)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_degrees_past_256_divide_as_bf16():
    """The degree 257 rounds to 256 as bf16 and 300 to 300; a counted degree
    stops at 256: the two rows divide by 256 either way, and the result
    differs from the f32 mean cast back in those rows."""
    src, dst, deg = graph()
    h = h_of(8, 1.0)
    counted, want = both(h, src, dst, None, 1 << 22)
    np.testing.assert_array_equal(bits(counted), bits(want))
    given, _ = both(h, src, dst, deg, 1 << 22)
    same = np.ones((N, 8), np.float32)
    ones, _ = both(same, src, dst, None, 1 << 22)
    assert float(ones[0, 0]) == 256 / 256 and float(ones[1, 0]) == 256 / 256
    f32 = spmm_mean(torch.tensor(h), torch.tensor(src.astype(np.int64)),
                    torch.tensor(dst.astype(np.int64)), N, torch.tensor(deg))
    assert not torch.equal(given[:2], f32[:2].to(torch.bfloat16))


def test_unsorted_edges_keep_each_rows_edge_order():
    """dst out of order: each row's messages still add in their COO order
    (JAX without sorted_dst; the port sorts the edges stably by dst)."""
    src, dst, deg = graph(2)
    perm = np.random.default_rng(3).permutation(src.shape[0])
    got, want = both(h_of(24, 1.0), src[perm], dst[perm], deg, 1 << 22, sorted_dst=False)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_zero_degree_rows_are_zero_and_sums_start_at_plus_zero():
    src, dst, deg = graph()
    h = h_of(6, 1.0)
    h[:] = -0.0
    got, want = both(h, src, dst, deg, 64)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert not bits(got).any()  # +0 everywhere, as XLA's sum from zeros


def test_the_bf16_mean_is_forward_only():
    src, dst, deg = graph()
    h = torch.tensor(h_of(4, 1.0)).to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        spmm_mean(h, torch.tensor(src.astype(np.int64)), torch.tensor(dst.astype(np.int64)),
                  N, torch.tensor(deg))
    with torch.no_grad():
        spmm_mean(h, torch.tensor(src.astype(np.int64)), torch.tensor(dst.astype(np.int64)),
                  N, torch.tensor(deg))


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    src, dst, deg = graph()
    index = segment.edges_by_row(torch.tensor(src.astype(np.int64)),
                                 torch.tensor(dst.astype(np.int64)), N)
    assert torch.equal(index.indptr.diff(), torch.tensor(deg.astype(np.int64)))
    h, d = torch.tensor(h_of(10, 1.0)).to(torch.bfloat16), torch.tensor(deg)
    segment.reset_launch_counts()
    assert torch.equal(segment.segment_mean_bf16(h, index, d),
                       segment.segment_mean_bf16_plain(h, index.src, index.indptr, d))
    assert segment.launch_counts() == {"segment_mean_bf16": 0, "csr_mean_f32": 0,
                                       "csr_mean_bf16": 0}
    with pytest.raises(ValueError):
        meta = segment.RowIndex(index.src.to("meta"), index.indptr.to("meta"), N)
        segment.segment_mean_bf16(h.to("meta"), meta, d.to("meta"))
    with pytest.raises(TypeError):
        segment.segment_mean_bf16(h.float(), index, d)


@pytest.fixture(scope="module")
def sage_pair():
    """The JAX and port bf16 SAGE (2 layers, 16 wide throughout) with TT
    cores of small dyadic values, so both lookups are exact."""
    kw = dict(num_nodes=N, in_dim=16, hidden_dim=16, num_classes=16, num_layers=2,
              tt_ranks=(2, 2), p_shapes=(6, 10, 10), q_shapes=(2, 2, 4),
              weight_dist="normal", bf16=True)
    jm = JaxSAGE(dropout=0.0, **kw)
    src, dst, deg = graph(4)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(dst),
                        jnp.asarray(deg), method=JaxSAGE.forward_full_graph)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(5)
    for k in range(3):
        c = params["embed"][f"tt_core_{k}"]
        params["embed"][f"tt_core_{k}"] = (rng.integers(-4, 5, c.shape) / 4).astype(np.float32)
    return jm, kw, params, (src, dst, deg)


def identity(params, scale_self: float = 0.0):
    """Convs whose neighbour weight is the identity and self weight zero:
    each conv's output is its mean, exactly."""
    out = jax.tree.map(np.copy, params)
    for i in range(2):
        out[f"conv_{i}"]["neigh"]["kernel"] = np.eye(16, dtype=np.float32)
        out[f"conv_{i}"]["self"]["kernel"] = np.eye(16, dtype=np.float32) * scale_self
        out[f"conv_{i}"]["self"]["bias"] = np.zeros(16, np.float32)
    return out


@pytest.mark.parametrize("convs", ["identity", "random"])
def test_sage_full_graph_forwards_under_bf16(sage_pair, convs):
    """forward_full_graph (evaluate) against JAX's, and JAX's forward_full
    (one layer from bf16 features) against spmm_mean then apply_conv, which
    is what it is: bit for bit with identity convs, within bf16 tolerance
    (the convs' products round in another order) with random ones."""
    jm, kw, params, (src, dst, deg) = sage_pair
    p = identity(params) if convs == "identity" else params
    ours = SAGE(dropout=0.0, **kw)
    ours.load_state_dict(params_from_jax(p), strict=True)
    s64, d64 = torch.tensor(src.astype(np.int64)), torch.tensor(dst.astype(np.int64))
    want = jm.apply({"params": p}, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(deg),
                    False, chunk=256, method=JaxSAGE.forward_full_graph)
    h = jnp.asarray(h_of(16, 1.0, seed=6)).astype(jnp.bfloat16)
    want_l = jm.apply({"params": p}, h, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(deg),
                      N, 0, chunk=256, method=JaxSAGE.forward_full)
    with torch.no_grad():
        got = ours.forward_full_graph(segment.FullGraph(s64, d64, N, torch.tensor(deg), 256))
        h_l = torch.tensor(h_of(16, 1.0, seed=6)).to(torch.bfloat16)
        got_l = ours.apply_conv(h_l, spmm_mean(h_l, s64, d64, N, torch.tensor(deg), chunk=256),
                                0)
    assert got.dtype == got_l.dtype == torch.bfloat16
    if convs == "identity":
        np.testing.assert_array_equal(bits(got), bits(want))
        np.testing.assert_array_equal(bits(got_l), bits(want_l))
    else:
        for a, b in ((got, want), (got_l, want_l)):
            b = np.asarray(b.astype(jnp.float32))
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                       atol=2e-2 * np.abs(b).max())

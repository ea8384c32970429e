"""The bf16 fan-out mean of the port's conv tower against the JAX package's
``jnp.mean(axis=2, dtype=bfloat16)``: forward and vector-Jacobian product
bit for bit (ROADMAP C1), the tower's means through SAGE, and what
``--bf16-mean-f32`` changes.  Also the full-graph SpMM mean of evaluate
under bf16, which now sums as the reference does (ROADMAP C2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset
from falcon_ttdforgnns_tpu.models.sage import SAGE as JaxSAGE
from falcon_ttdforgnns_tpu.ops.segment import spmm_mean as jax_spmm_mean

from falcon_ttdforgnns_torch.convert import params_from_jax
from falcon_ttdforgnns_torch.models.sage import SAGE
from falcon_ttdforgnns_torch.ops import tower
from falcon_ttdforgnns_torch.ops.segment import spmm_mean


def bits(x) -> np.ndarray:
    """A bf16 array (jax or torch) as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def draw(shape, scale, seed):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("f", [1, 2, 5, 10, 15])
@pytest.mark.parametrize("d", [7, 100])
@pytest.mark.parametrize("scale", [1.0, 3e4], ids=["normal", "large"])
def test_fanout_mean_matches_jax_bit_for_bit(f, d, scale):
    """Forward and backward of fanout_mean_bf16 (on the CPU its plain
    versions) against JAX's bf16 mean and its vjp: every bit equal."""
    x = draw((12, 6, f, d), scale, f * 100 + d)
    g = draw((12, 6, d), scale, f * 100 + d + 1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda t: t.mean(axis=2, dtype=jnp.bfloat16), xj)
    (want_dx,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    got = tower.fanout_mean_bf16(xt)
    got.backward(torch.tensor(g).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(xt.grad), bits(want_dx))


def test_fanout_mean_differs_from_pytorch_mean():
    """PyTorch's bf16 mean accumulates in f32 (it equals mean(dtype=float32)
    cast back): that is what the port computed before, and most outputs of
    a 15-term mean differ from the reference's bf16 partial sums."""
    x = torch.tensor(draw((64, 10, 15, 100), 1.0, 0)).to(torch.bfloat16)
    ours = tower.fanout_mean_bf16(x)
    assert torch.equal(x.mean(dim=2), x.mean(dim=2, dtype=torch.float32).to(torch.bfloat16))
    assert float((ours != x.mean(dim=2)).float().mean()) > 0.3


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    tower.reset_launch_counts()
    x = torch.tensor(draw((4, 3, 5, 8), 1.0, 1)).to(torch.bfloat16)
    assert torch.equal(tower.fanout_mean_bf16_fwd(x), tower.fanout_mean_bf16_plain(x))
    assert torch.equal(tower.fanout_mean_bf16_bwd(x[:, :, 0], 5),
                       tower.fanout_mean_bf16_bwd_plain(x[:, :, 0], 5))
    assert tower.launch_counts() == dict.fromkeys(tower.KERNELS, 0)
    with pytest.raises(ValueError):
        tower.fanout_mean_bf16_fwd(x.to("meta"))


@pytest.fixture(scope="module")
def bf16_case():
    kw = dict(num_nodes=2000, in_dim=32, hidden_dim=24, num_classes=5, num_layers=3,
              tt_ranks=(4, 4), weight_dist="normal")
    B, fanouts = 16, (2, 3, 4)
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 2000, B).astype(np.int32)
    layers, f = [], 1
    for fo in reversed(fanouts):
        f *= fo
        layers.append(rng.integers(0, 2000, (B, f)).astype(np.int32))
    h_all = rng.normal(size=(B * (1 + 4 + 12 + 24), 32)).astype(np.float32)
    return kw, seeds, layers, h_all


def tower_logits(bf16_case, **flags):
    """Logits of the JAX SAGE and the port's from the same embeddings and
    weights, with the bf16 tower and `flags`."""
    kw, seeds, layers, h_all = bf16_case
    jax_model = JaxSAGE(dropout=0.0, bf16=True, **kw, **flags)
    variables = jax_model.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(0)},
                               jnp.asarray(seeds), [jnp.asarray(l) for l in layers],
                               train=False)
    want = jax_model.apply(variables, jnp.asarray(h_all), jnp.asarray(seeds),
                           [jnp.asarray(l) for l in layers],
                           method=JaxSAGE.forward_from_embeddings)
    ours = SAGE(dropout=0.0, bf16=True, **kw, **flags)
    ours.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    with torch.no_grad():
        got = ours.forward_from_embeddings(torch.tensor(h_all), torch.tensor(seeds),
                                           [torch.tensor(l) for l in layers])
    return got.numpy(), np.asarray(want)


def test_bf16_tower_means_are_jax_means(bf16_case):
    """The whole bf16 tower from the same embeddings: the means now round
    as JAX's do, so the f32 logits agree to 1e-2 of their scale (the convs'
    bf16 products round in another order), and the tower with
    --bf16-mean-f32 agrees with JAX's the same way."""
    for flags in ({}, dict(mean_acc_f32=True)):
        got, want = tower_logits(bf16_case, **flags)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_bf16_mean_f32_changes_the_output_in_both(bf16_case):
    """--bf16-mean-f32 changes the logits in the JAX package, and now in the
    port too (before, the port's bf16 mean already accumulated in f32)."""
    ours_bf16, jax_bf16 = tower_logits(bf16_case)
    ours_f32, jax_f32 = tower_logits(bf16_case, mean_acc_f32=True)
    assert not np.array_equal(jax_bf16, jax_f32)
    assert not np.array_equal(ours_bf16, ours_f32)


def test_evaluate_bf16_spmm_mean_is_jax_bit_for_bit():
    """ROADMAP C2, closed: under bf16 the reference's full-graph mean (XLA's
    segment sum) adds each dst row's messages in edge order with a bf16
    rounding after every add.  The port's bf16 spmm_mean now does the same
    (segment_mean_bf16; before, index_add_ summed in f32 and rounded once,
    and about half the outputs differed), so every bit equals JAX's, and
    equals the sequential bf16 sum written out here; index_add_'s f32 sum
    cast back still differs in many outputs."""
    g = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, seed=1).graph
    src, dst = g.to_coo()
    deg = g.degrees.astype(np.float32)
    h = torch.tensor(draw((2000, 24), 1.0, 5)).to(torch.bfloat16)
    want = jax_spmm_mean(jnp.asarray(h.float().numpy()).astype(jnp.bfloat16), jnp.asarray(src),
                         jnp.asarray(dst), 2000, jnp.asarray(deg), sorted_dst=True)
    s64, d64 = torch.tensor(src.astype(np.int64)), torch.tensor(dst.astype(np.int64))
    ours = spmm_mean(h, s64, d64, 2000, torch.tensor(deg))
    np.testing.assert_array_equal(bits(ours), bits(want))
    f32_sum = torch.zeros((2000, 24)).index_add_(0, d64, h.float().index_select(0, s64))
    cast = (f32_sum.to(torch.bfloat16).float()
            / torch.clamp(torch.tensor(deg).to(torch.bfloat16), min=1.0).float()[:, None])
    assert float((bits(cast.to(torch.bfloat16)) != bits(want)).mean()) > 0.3
    # the edge-order bf16 sum: the k-th in-edge of every row at once
    rank = np.arange(len(dst)) - g.indptr[dst]
    acc = torch.zeros((2000, 24), dtype=torch.bfloat16)
    msgs = h.index_select(0, s64)
    for k in range(int(rank.max()) + 1):
        sel = torch.tensor(np.nonzero(rank == k)[0])
        rows = d64[sel]
        acc[rows] = acc[rows] + msgs[sel]
    seq = acc / torch.clamp(torch.tensor(deg).to(torch.bfloat16), min=1.0)[:, None]
    np.testing.assert_array_equal(bits(seq), bits(want))

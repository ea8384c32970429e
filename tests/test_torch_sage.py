"""SAGEConv and SAGE of the port against the flax modules, with the flax
params carried over by ``params_from_jax``: the same logits on the same
batch (sampled forward, forward from embeddings, full-graph forward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_ttdforgnns_tpu.models.sage import SAGE as JaxSAGE
from falcon_ttdforgnns_tpu.nn.layers import SAGEConv as JaxSAGEConv
from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset

from falcon_ttdforgnns_torch.convert import params_from_jax
from falcon_ttdforgnns_torch.models.sage import SAGE, collect_level_ids, dropout
from falcon_ttdforgnns_torch.nn.layers import SAGEConv, lecun_normal_

RTOL = 1e-5  # f32 matmuls in both frameworks, summed in another order


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_sageconv_matches_flax():
    rng = np.random.default_rng(0)
    h_dst = rng.normal(size=(6, 4, 16)).astype(np.float32)
    h_nb = rng.normal(size=(6, 4, 16)).astype(np.float32)
    conv = JaxSAGEConv(8)
    params = conv.init(jax.random.PRNGKey(1), h_dst, h_nb)["params"]
    want = conv.apply({"params": params}, h_dst, h_nb)
    ours = SAGEConv(16, 8)
    sd = params_from_jax({"embed": {}, "conv_0": to_numpy(params)})
    ours.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    assert_close(ours(torch.tensor(h_dst), torch.tensor(h_nb)).detach(), want)


def test_lecun_normal_statistics():
    w = lecun_normal_(torch.empty(512, 400), torch.Generator().manual_seed(0))
    assert abs(float(w.std()) - (1 / 400) ** 0.5) < 0.05 * (1 / 400) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / 0.87962566103423978 + 1e-6


@pytest.fixture(scope="module")
def models():
    kw = dict(num_nodes=2000, in_dim=32, hidden_dim=24, num_classes=5, num_layers=3,
              tt_ranks=(4, 4), weight_dist="normal")
    jax_model = JaxSAGE(dropout=0.5, **kw)
    B, fanouts = 16, (2, 3, 4)
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2000, B).astype(np.int32)
    layers, f = [], 1
    for fo in reversed(fanouts):
        f *= fo
        layers.append(rng.integers(0, 2000, (B, f)).astype(np.int32))
    variables = jax_model.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(0)},
                               jnp.asarray(seeds), [jnp.asarray(l) for l in layers],
                               train=False)
    ours = SAGE(dropout=0.5, **kw)
    ours.load_state_dict(params_from_jax(to_numpy(variables["params"])), strict=True)
    return jax_model, variables, ours, seeds, layers


def test_sampled_forward_matches(models):
    jax_model, variables, ours, seeds, layers = models
    want = jax_model.apply(variables, jnp.asarray(seeds), [jnp.asarray(l) for l in layers])
    with torch.no_grad():
        got = ours(torch.tensor(seeds), [torch.tensor(l) for l in layers])
    assert got.shape == (16, 5)
    assert_close(got, want)


def test_forward_from_embeddings_matches(models):
    jax_model, variables, ours, seeds, layers = models
    all_ids, sizes, B = collect_level_ids(torch.tensor(seeds), [torch.tensor(l) for l in layers])
    assert sizes == [1, 4, 12, 24] and all_ids[:B].tolist() == seeds.tolist()
    h_all = np.random.default_rng(4).normal(size=(all_ids.shape[0], 32)).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(h_all), jnp.asarray(seeds),
                           [jnp.asarray(l) for l in layers],
                           method=JaxSAGE.forward_from_embeddings)
    with torch.no_grad():
        got = ours.forward_from_embeddings(torch.tensor(h_all), torch.tensor(seeds),
                                           [torch.tensor(l) for l in layers])
    assert_close(got, want)


def test_forward_full_graph_matches(models):
    jax_model, variables, ours, _, _ = models
    g = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, seed=1).graph
    src, dst = g.to_coo()
    deg = g.degrees.astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(deg),
                           False, chunk=4096, method=JaxSAGE.forward_full_graph)
    with torch.no_grad():
        got = ours.forward_full_graph(torch.tensor(src.astype(np.int64)),
                                      torch.tensor(dst.astype(np.int64)),
                                      torch.tensor(deg), chunk=4096)
    assert got.shape == (2000, 5)
    assert_close(got, want)


def test_dropout_semantics():
    h = torch.ones(2000)
    out = dropout(h, 0.25, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert dropout(h, 0.25, False, None) is h

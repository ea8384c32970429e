"""RGAT and the molecular GIN/GCN stack of the port against the JAX
package's, with the flax params and batch statistics carried in by
``convert.rgat_state_from_jax`` / ``mol_gnn_state_from_jax``, on the CPU in
f32.  Eval mode within 1e-5 of the largest output (sums in another order);
one train-mode forward and backward with dropout 0: the outputs the same
way, the BatchNorm statistics within 1e-5 (1e-8 at least) and every gradient within
1e-4 of its tensor's largest value or, for a gradient that is zero in real
arithmetic (a Dense bias just before a train-mode BatchNorm), of the
model's largest gradient (the backward's sums through BatchNorm and the
attention's softmax in another order).  The JAX side runs jitted.  The
molecule batches hold
an empty padding graph; a segment max with a tie shares its gradient as
JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.models.gin import GNNNode as JaxGNNNode
from falcon_ttdforgnns_tpu.models.gin import MolGNN as JaxMolGNN
from falcon_ttdforgnns_tpu.models.gin import graph_pool as jax_graph_pool
from falcon_ttdforgnns_tpu.models.rgat import RGAT as JaxRGAT

from falcon_ttdforgnns_torch.convert import mol_gnn_state_from_jax, rgat_state_from_jax
from falcon_ttdforgnns_torch.models.gin import GNNNode, MolGNN, graph_pool
from falcon_ttdforgnns_torch.models.rgat import RGAT

KEY = jax.random.PRNGKey(0)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def check_grads(model, want_state, skip=("bias_ih",)):
    """Each parameter's gradient against the JAX gradient mapped by the
    converter (flax's LSTM cells have no input bias: ``bias_ih``'s gradient
    equals ``bias_hh``'s and is not held)."""
    top = max(float(v.abs().max()) for v in want_state.values() if v.numel())
    for name, p in model.named_parameters():
        if name.endswith(skip):
            continue
        want = want_state[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-2 * top),
                                   err_msg=name)


# ---------------------------------------------------------------------- RGAT
def typed_graph(n=60, d=8, etypes=3, seed=0):
    rng = np.random.default_rng(seed)
    edges = [(rng.integers(0, n, 150), rng.integers(0, n, 150)) for _ in range(etypes)]
    feat = rng.normal(size=(n, d)).astype(np.float32)
    return n, feat, edges


@pytest.mark.parametrize("heads,layers", [(2, 2), (3, 1)])
def test_rgat_matches_jax(heads, layers):
    n, feat, edges = typed_graph()
    jm = JaxRGAT(in_dim=8, hidden_dim=4, num_classes=6, num_etypes=3, num_layers=layers,
                 num_heads=heads, dropout=0.0)
    jedges = [(jnp.asarray(s), jnp.asarray(d)) for s, d in edges]
    vs = jax.jit(lambda f, e: jm.init({"params": KEY, "dropout": KEY}, f, e, n))(
        jnp.asarray(feat), jedges)
    ours = RGAT(8, 4, 6, 3, layers, heads, dropout=0.0)
    ours.load_state_dict(rgat_state_from_jax(np_tree(vs["params"])), strict=True)
    tedges = [(torch.tensor(s), torch.tensor(d)) for s, d in edges]
    want = jax.jit(lambda v, f, e: jm.apply(v, f, e, n, train=False))(
        vs, jnp.asarray(feat), jedges)
    with torch.no_grad():
        close(ours(torch.tensor(feat), tedges, n), want, 1e-5)
    # a train-mode forward and backward (dropout 0)
    w = np.random.default_rng(1).normal(size=(n, 6)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(feat), jedges, n, train=True,
                       rngs={"dropout": KEY})
        return jnp.sum(out * w)

    grads = rgat_state_from_jax(np_tree(jax.jit(jax.grad(loss))(vs["params"])))
    (ours(torch.tensor(feat), tedges, n, train=True) * torch.tensor(w)).sum().backward()
    check_grads(ours, grads)


# --------------------------------------------------------- the molecular stack
def mol_batch(graphs=5, seed=0):
    """``graphs`` molecule-like graphs of 6-12 atoms (a ring and a chain,
    both edge directions, bond features within (5, 6, 2)), then one empty
    padding graph."""
    rng = np.random.default_rng(seed)
    src, dst, gid, off = [], [], [], 0
    for g in range(graphs):
        k = int(rng.integers(6, 13))
        ring = min(6, k)
        a = list(range(ring)) + list(range(ring - 1, k - 1))
        b = list(range(1, ring)) + [0] + list(range(ring, k))
        a, b = np.array(a) + off, np.array(b) + off
        src += [a, b]
        dst += [b, a]
        gid.append(np.full(k, g))
        off += k
    src, dst = np.concatenate(src), np.concatenate(dst)
    attr = np.stack([rng.integers(0, c, len(src)) for c in (5, 6, 2)], 1)
    x = rng.normal(size=(off, 9)).astype(np.float32)
    return dict(x=x, src=src, dst=dst, edge_attr=attr, graph_id=np.concatenate(gid),
                num_nodes=off, num_graphs=graphs + 1)


def jax_args(b):
    return (jnp.asarray(b["x"]), jnp.asarray(b["src"]), jnp.asarray(b["dst"]),
            jnp.asarray(b["edge_attr"]), jnp.asarray(b["graph_id"]), b["num_nodes"],
            b["num_graphs"])


def torch_args(b):
    return (torch.tensor(b["x"]), torch.tensor(b["src"]), torch.tensor(b["dst"]),
            torch.tensor(b["edge_attr"]), torch.tensor(b["graph_id"]), b["num_nodes"],
            b["num_graphs"])


def jitted(jm, b, **kw):
    """``jm.apply`` on the batch's arrays, jitted (the sizes static)."""
    n, g = b["num_nodes"], b["num_graphs"]
    return jax.jit(lambda v, *a: jm.apply(v, *a, n, g, **kw))


def with_stats(jm, b):
    """Init, then one train-mode pass so the batch statistics are not the
    initial 0 and 1 (the eval comparison then exercises them)."""
    n, g = b["num_nodes"], b["num_graphs"]
    vs = jax.jit(lambda *a: jm.init({"params": KEY, "dropout": KEY}, *a, n, g))(
        *jax_args(b)[:5])
    _, st = jitted(jm, b, train=True, rngs={"dropout": KEY}, mutable=["batch_stats"])(
        vs, *jax_args(b)[:5])
    return {"params": vs["params"], "batch_stats": st["batch_stats"]}


def compare(jm, ours, vs, node_only, b, w):
    """Eval outputs, then one train-mode pass: outputs, new batch
    statistics and gradients."""
    ours.load_state_dict(mol_gnn_state_from_jax(np_tree(vs), node_only), strict=True)
    with torch.no_grad():
        close(ours(*torch_args(b)), jitted(jm, b, train=False)(vs, *jax_args(b)[:5]), 1e-5)
    n, ng = b["num_nodes"], b["num_graphs"]

    def loss(p, *a):
        out, st = jm.apply({"params": p, "batch_stats": vs["batch_stats"]}, *a, n, ng,
                           train=True, rngs={"dropout": KEY}, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, st)

    (_, (want, st)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        vs["params"], *jax_args(b)[:5])
    out = ours(*torch_args(b), train=True)
    close(out, want, 1e-5)
    new_stats = mol_gnn_state_from_jax(np_tree({"params": vs["params"],
                                                "batch_stats": st["batch_stats"]}), node_only)
    for name, buf in ours.named_buffers():
        # a statistic of activations of order 1; a mean that cancels to
        # rounding noise (a zero-bias Dense of BatchNorm'd rows) is held at 1e-8
        want_buf = new_stats[name].numpy()
        np.testing.assert_allclose(buf.numpy(), want_buf, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want_buf).max(), 1e-3), err_msg=name)
    (out * torch.tensor(np.asarray(w))).sum().backward()
    check_grads(ours, mol_gnn_state_from_jax(np_tree({"params": g,
                                                      "batch_stats": st["batch_stats"]}),
                                             node_only))


@pytest.mark.parametrize("pooling", ["sum", "mean", "max", "attention", "set2set"])
@pytest.mark.parametrize("conv", ["gin", "gcn"])
def test_mol_gnn_matches_jax(conv, pooling):
    b = mol_batch()
    jm = JaxMolGNN(num_tasks=3, emb_dim=16, num_layers=2, conv_type=conv, virtual_node=True,
                   pooling=pooling, dropout=0.0)
    vs = with_stats(jm, b)
    ours = MolGNN(3, 9, emb_dim=16, num_layers=2, conv_type=conv, virtual_node=True,
                  pooling=pooling, dropout=0.0)
    w = np.random.default_rng(2).normal(size=(b["num_graphs"], 3)).astype(np.float32)
    compare(jm, ours, vs, False, b, w)


@pytest.mark.parametrize("virtual_node,residual", [(False, False), (True, True),
                                                   (False, True)])
@pytest.mark.parametrize("conv", ["gin", "gcn"])
def test_gnn_node_matches_jax(conv, virtual_node, residual):
    b = mol_batch(seed=3)
    jm = JaxGNNNode(emb_dim=12, num_layers=3, conv_type=conv, virtual_node=virtual_node,
                    dropout=0.0, residual=residual)
    vs = with_stats(jm, b)
    ours = GNNNode(9, 12, 3, conv, virtual_node, dropout=0.0, residual=residual)
    w = np.random.default_rng(4).normal(size=(b["num_nodes"], 12)).astype(np.float32)
    compare(jm, ours, vs, True, b, w)


def test_empty_graph_pools_to_zero():
    b = mol_batch()
    h = np.random.default_rng(5).normal(size=(b["num_nodes"], 4)).astype(np.float32) - 10
    for method in ("sum", "mean", "max"):
        got = graph_pool(torch.tensor(h), torch.tensor(b["graph_id"]), b["num_graphs"], method)
        want = jax_graph_pool(jnp.asarray(h), jnp.asarray(b["graph_id"]), b["num_graphs"],
                              method)
        close(got, want, 1e-6)
        assert not got[-1].any()  # the padding graph


def test_segment_max_tie_shares_the_gradient_as_jax():
    """Two rows of a graph tie at its max (and a third ties in another
    column): the gradient reaching h is JAX's."""
    h = np.array([[1.0, 2.0], [3.0, 2.0], [3.0, 0.5], [0.0, 7.0], [-1.0, 7.0]], np.float32)
    gid = np.array([0, 0, 0, 1, 1])
    w = np.array([[1.5, -2.0], [0.5, 3.0], [4.0, 4.0]], np.float32)
    want = jax.grad(lambda t: jnp.sum(jax_graph_pool(t, jnp.asarray(gid), 3, "max") * w))(
        jnp.asarray(h))
    ht = torch.tensor(h, requires_grad=True)
    (graph_pool(ht, torch.tensor(gid), 3, "max") * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(ht.grad.numpy(), np.asarray(want))
    assert float(ht.grad[1, 0]) == float(ht.grad[2, 0]) == 0.75

"""Full-graph GCN/GAT of the port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
variables are carried into the port by ``convert.full_graph_state_from_jax``.
Tolerances (f32 on both sides, sums in other orders):

* layers and models: 1e-5 relative with an absolute floor of 1e-5 times
  the largest value; BatchNorm's running statistics 1e-6;
* the trainer after 3 AdamW steps: losses 1e-5 relative, parameters within
  1e-4 relative plus an absolute 3 * 1e-3 * lr (Adam's normalised step turns
  the reordering error of a near-cancelled gradient element into up to
  ~1e-3 lr per step), running statistics 1e-4;
* the lr schedule: optax's f32 value to 1e-7.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.models.gat import GAT as JGAT
from falcon_ttdforgnns_tpu.models.gcn import GCN as JGCN
from falcon_ttdforgnns_tpu.nn.layers import GATConv as JGATConv
from falcon_ttdforgnns_tpu.nn.layers import GraphConv as JGraphConv
from falcon_ttdforgnns_tpu.ops.spmm_blocked import build_blocked_spmm as jax_blocked
from falcon_ttdforgnns_tpu.train import FullGraphConfig as JConfig
from falcon_ttdforgnns_tpu.train import FullGraphTrainer as JTrainer
from falcon_ttdforgnns_tpu.train import log_eps_cross_entropy as jax_log_eps_ce

from falcon_ttdforgnns_torch.convert import full_graph_state_from_jax
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.models.gat import GAT
from falcon_ttdforgnns_torch.models.gcn import GCN
from falcon_ttdforgnns_torch.nn.layers import BatchNorm, GATConv, GraphConv
from falcon_ttdforgnns_torch.ops.spmm_blocked import build_blocked_spmm
from falcon_ttdforgnns_torch.train import (FullGraphConfig, FullGraphTrainer,
                                           log_eps_cross_entropy)
from falcon_ttdforgnns_torch.train.full_graph import warmup_lr


def close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def graph(n=500, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.sort(rng.integers(0, n, e))
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    return src, dst, deg


def lin_from(dense):
    return torch.tensor(np.asarray(dense["kernel"]).T.copy())


# --------------------------------------------------------------- BatchNorm
def test_batchnorm_matches_flax_train_and_eval():
    """Biased variance both to normalise and in the running variance,
    momentum 0.99 on the old value; on 500 rows torch's BatchNorm1d
    (unbiased running variance) is off by N/(N-1)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(500, 16)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    mean0, var0 = rng.normal(size=16).astype(np.float32), rng.random(16).astype(np.float32) + 0.5
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
        bn.running_mean.copy_(torch.tensor(mean0))
        bn.running_var.copy_(torch.tensor(var0))
    want, upd = fnn.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    got = bn(torch.tensor(x), train=True)
    close(got.detach().numpy(), want)
    close(bn.running_mean.numpy(), upd["batch_stats"]["mean"], 1e-6)
    close(bn.running_var.numpy(), upd["batch_stats"]["var"], 1e-6)
    variables["batch_stats"] = upd["batch_stats"]
    close(bn(torch.tensor(x), train=False).detach().numpy(),
          fnn.BatchNorm(use_running_average=True).apply(variables, jnp.asarray(x)))
    torch_bn = torch.nn.BatchNorm1d(16, momentum=0.01)
    torch_bn.running_var.copy_(torch.tensor(var0))
    torch_bn(torch.tensor(x))
    assert not np.allclose(torch_bn.running_var.numpy(), upd["batch_stats"]["var"], rtol=1e-6,
                           atol=0)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("route", ["xla", "blocked"])
def test_graphconv_matches_flax(route):
    n = 500
    src, dst, deg = graph(n)
    h = np.random.default_rng(1).normal(size=(n, 12)).astype(np.float32)
    args = (jnp.asarray(h), jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)),
            jnp.asarray(deg), n)
    if route == "blocked":
        jop = jax_blocked(src, dst, n, tile=256, dst_buckets=16, chunk_tiles=8)
        layer = JGraphConv(8, blocked_tile=256)
        jargs = args + ((jop.fwd, jop.bwd),)
    else:
        layer, jargs = JGraphConv(8), args
    variables = layer.init(jax.random.PRNGKey(0), *jargs)
    want = layer.apply(variables, *jargs)
    conv = GraphConv(12, 8)
    with torch.no_grad():
        conv.lin.weight.copy_(lin_from(variables["params"]["Dense_0"]))
        conv.lin.bias.copy_(torch.tensor(np.asarray(variables["params"]["Dense_0"]["bias"])))
    op = build_blocked_spmm(src, dst, n, tile=256, dst_buckets=16, chunk_tiles=8,
                            device="cpu") \
        if route == "blocked" else None
    got = conv(torch.tensor(h), torch.tensor(src), torch.tensor(dst), torch.tensor(deg), n, op)
    close(got.detach().numpy(), want)


@pytest.mark.parametrize("sym", [False, True], ids=["no_norm", "both_norm"])
def test_gatconv_forward_and_grads_match_flax(sym):
    n, H, Do = 400, 3, 8
    src, dst, deg = graph(n, 2500, seed=2)
    deg[::7] = 0  # rows without in-edges: an empty softmax segment
    keep = ~np.isin(dst, np.arange(0, n, 7))
    src, dst = src[keep], dst[keep]
    h = np.random.default_rng(3).normal(size=(n, 10)).astype(np.float32)
    g = np.random.default_rng(4).normal(size=(n, H * Do)).astype(np.float32)
    layer = JGATConv(Do, num_heads=H, use_symmetric_norm=sym, edge_chunk=700)
    sj, dj = jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32))
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(h), sj, dj, jnp.asarray(deg), n)

    def loss_j(params):
        out = layer.apply({"params": params}, jnp.asarray(h), sj, dj, jnp.asarray(deg), n)
        return jnp.sum(out * g), out

    (_, want), gj = jax.value_and_grad(loss_j, has_aux=True)(variables["params"])
    conv = GATConv(10, Do, num_heads=H, use_symmetric_norm=sym, edge_chunk=700)
    p = variables["params"]
    with torch.no_grad():
        conv.fc.weight.copy_(lin_from(p["fc"]))
        conv.res_fc.weight.copy_(lin_from(p["res_fc"]))
        conv.attn_l.copy_(torch.tensor(np.asarray(p["attn_l"])))
        conv.attn_r.copy_(torch.tensor(np.asarray(p["attn_r"])))
    got = conv(torch.tensor(h), torch.tensor(src), torch.tensor(dst), torch.tensor(deg), n,
               train=True)  # attention dropout 0: train mode is deterministic
    (got * torch.tensor(g)).sum().backward()
    close(got.detach().numpy(), want)
    close(conv.fc.weight.grad.numpy(), np.asarray(gj["fc"]["kernel"]).T)
    close(conv.res_fc.weight.grad.numpy(), np.asarray(gj["res_fc"]["kernel"]).T)
    close(conv.attn_l.grad.numpy(), gj["attn_l"])
    close(conv.attn_r.grad.numpy(), gj["attn_r"])


def test_gat_attention_init_uses_flax_fans():
    """glorot_uniform over (1, H, Do) with flax's fans (fan_in = H, fan_out =
    Do): U(-a, a), a = sqrt(6 / (H + Do)); xavier_uniform_ would take fan_in
    = H * Do and a far smaller bound."""
    H, Do = 4, 512
    conv = GATConv(8, Do, num_heads=H, generator=torch.Generator().manual_seed(0))
    a = math.sqrt(6.0 / (H + Do))
    ref = jax.nn.initializers.glorot_uniform()(jax.random.PRNGKey(0), (1, H, Do))
    for p in (conv.attn_l, conv.attn_r):
        v = p.detach().numpy()
        assert v.shape == (1, H, Do)
        assert np.abs(v).max() <= a and np.abs(v).max() > 0.98 * a
        assert abs(v.var() / (a * a / 3) - 1) < 0.1
    assert abs(float(np.abs(np.asarray(ref)).max()) / a - 1) < 0.02
    assert abs(float(np.asarray(ref).var()) / (a * a / 3) - 1) < 0.1


# ------------------------------------------------------------------ models
def carry(torch_model, jax_params, jax_stats=None):
    """A bare GCN/GAT's flax tree into the port's (the FullGraphModel tree
    minus its "gnn" level)."""
    variables = {"params": {"embed": {}, "gnn": jax_params}}
    if jax_stats is not None:
        variables["batch_stats"] = {"gnn": jax_stats}
    state = {k[len("gnn."):]: v for k, v in full_graph_state_from_jax(variables).items()}
    torch_model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("model", ["gcn", "gat"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_models_match_flax(model, train):
    """Eval mode (running statistics) and train mode with both dropouts 0
    (batch statistics, updated running statistics)."""
    n = 500
    src, dst, deg = graph(n, 3500, seed=5)
    feat = np.random.default_rng(6).normal(size=(n, 16)).astype(np.float32)
    jargs = (jnp.asarray(feat), jnp.asarray(src.astype(np.int32)),
             jnp.asarray(dst.astype(np.int32)), jnp.asarray(deg))
    if model == "gcn":
        jm = JGCN(16, 12, 5, num_layers=3, dropout=0.0, use_linear=True)
        tm = GCN(16, 12, 5, num_layers=3, dropout=0.0, use_linear=True)
    else:
        jm = JGAT(16, 6, 5, num_layers=3, num_heads=2, dropout=0.0, attn_dropout=0.0,
                  use_linear=True)
        tm = GAT(16, 6, 5, num_layers=3, num_heads=2, dropout=0.0, attn_dropout=0.0,
                 use_linear=True)
    variables = jm.init(jax.random.PRNGKey(3), *jargs, train=False)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1, variables["batch_stats"])  # not 0/1
    variables = {"params": variables["params"], "batch_stats": stats}
    carry(tm, variables["params"], variables["batch_stats"])
    want, upd = jm.apply(variables, *jargs, train=train, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(0)})
    got = tm(torch.tensor(feat), torch.tensor(src), torch.tensor(dst), torch.tensor(deg),
             train=train)
    close(got.detach().numpy(), want)
    for i, bn in enumerate(tm.bns):
        close(bn.running_mean.numpy(), upd["batch_stats"][f"bn_{i}"]["mean"], 1e-5)
        close(bn.running_var.numpy(), upd["batch_stats"][f"bn_{i}"]["var"], 1e-5)


def test_log_eps_cross_entropy_matches_jax():
    logits = np.random.default_rng(0).normal(size=(32, 5)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 5, 32)
    close(float(log_eps_cross_entropy(torch.tensor(logits), torch.tensor(labels))),
          float(jax_log_eps_ce(jnp.asarray(logits), jnp.asarray(labels))))


@pytest.mark.parametrize("W", [1, 3, 50])
def test_warmup_lr_matches_optax(W):
    lr = 0.005
    B = max(W - 1, 1)
    sched = optax.join_schedules([optax.linear_schedule(lr / W, lr, B),
                                  optax.constant_schedule(lr)], [B])
    for step in range(0, 60):
        assert warmup_lr(step, lr, W) == pytest.approx(float(sched(step)), rel=1e-7)
    # step 0 trains, at lr / W up to the schedule's f32 arithmetic
    assert warmup_lr(0, lr, W) == pytest.approx(lr / W, rel=1e-5)


# ----------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_nodes=500, avg_degree=6, num_classes=4, feat_dim=16, seed=1)
    return hard_synthetic_dataset(**kw), jax_hard(**kw)


BASE = dict(epochs=3, lr=0.005, hidden_dim=16, num_layers=3, tt_ranks=(4, 4),
            weight_dist="normal", dropout=0.0, warmup_epochs=3, seed=0)


def build_both(datasets, **kw):
    ds, jds = datasets
    jtr = JTrainer(jds, JConfig(**BASE, **kw))
    tr = FullGraphTrainer(ds, FullGraphConfig(**BASE, **kw), device="cpu")
    tr.model.load_state_dict(full_graph_state_from_jax(jax.tree.map(np.asarray, jtr.variables)))
    return jtr, tr


def check_state(jtr, tr, lr):
    want = full_graph_state_from_jax(jax.tree.map(np.asarray, jtr.variables))
    ours = tr.model.state_dict()
    assert set(ours) == set(want)
    for k, w in want.items():
        tol = 1e-4 if "running" in k else 0.0
        np.testing.assert_allclose(ours[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=max(tol * float(w.abs().max()), 3 * 1e-3 * lr), err_msg=k)


@pytest.mark.parametrize("use_labels", [False, True], ids=["plain", "labels"])
@pytest.mark.parametrize("spmm", ["xla", "blocked"])
def test_gcn_three_steps_match_jax(datasets, spmm, use_labels):
    """3 epochs (one step each) of the warmup AdamW, dropout 0, with the
    label trick on and off, through index_add_ and through the blocked SpMM
    (the JAX side: Pallas in interpret mode); then evaluate()."""
    jtr, tr = build_both(datasets, model="gcn", spmm=spmm, use_labels=use_labels,
                         use_linear=True)
    for e in range(3):
        lj = jtr.train_epoch(e)["loss"]
        lt = tr.train_epoch(e)["loss"]
        assert lt == pytest.approx(lj, rel=1e-5)
    assert tr.step == 3
    check_state(jtr, tr, BASE["lr"])
    tr.model.load_state_dict(full_graph_state_from_jax(jax.tree.map(np.asarray, jtr.variables)))
    ours, theirs = tr.evaluate(), jtr.evaluate()
    ds = datasets[0]
    for split, idx in (("train", ds.train_idx), ("val", ds.val_idx), ("test", ds.test_idx)):
        assert abs(ours[f"{split}_acc"] - theirs[f"{split}_acc"]) <= 1.0 / len(idx) + 1e-7


def test_gat_trainer_eval_matches_jax(datasets):
    """GAT's attention dropout is fixed at 0.05 in the trainer, and dropout
    bits differ between the frameworks: trainer parity is eval mode."""
    jtr, tr = build_both(datasets, model="gat", num_heads=2)
    logits_j = np.asarray(jtr._eval(jtr.variables, jtr.src, jtr.dst, jtr.in_deg, jtr.labels,
                                    jtr._label_mask(np.asarray(jtr.train_idx)), None))
    close(tr.logits().numpy(), logits_j)
    assert tr.evaluate() == jtr.evaluate()
    loss = tr.train_epoch(0)["loss"]
    assert np.isfinite(loss) and tr.step == 1


def test_rejections(datasets):
    ds = datasets[0]
    with pytest.raises(ValueError, match="pallas"):
        FullGraphTrainer(ds, FullGraphConfig(model="gcn", spmm="pallas"), device="cpu")
    with pytest.raises(ValueError, match="GAT"):
        FullGraphTrainer(ds, FullGraphConfig(model="gat", spmm="blocked"), device="cpu")


def test_materialize_features(datasets):
    tr = FullGraphTrainer(datasets[0], FullGraphConfig(**BASE), device="cpu")
    rows = tr.model.materialize_features(torch.arange(32, dtype=torch.int32))
    assert rows.shape == (32, datasets[0].feat_dim)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_cli_full_graph_on_cpu(model, capsys, tmp_path):
    from falcon_ttdforgnns_torch import cli
    common = ["--device", "cpu", "--model", model, "--dataset", "hard-ogbn-arxiv",
              "--synthetic-scale", "0.01", "--num-hidden", "16", "--num-layers", "2",
              "--num-heads", "2", "--tt-rank", "4,4", "--log-dir", str(tmp_path)]
    cli.main(common + ["--run-one"])
    cli.main(common + ["--epochs", "2", "--eval-every", "2"])
    assert '"best"' in capsys.readouterr().out

"""The sampled GAT of ``models/gat_ns.py`` (``--model gat-ns``) through
``SageTrainer`` against the benchmark's plain reference
``gnnbench/reference/gat.py`` on seeded random weights, on the CPU: the
full-graph logits in f32 and bf16, one training step's loss and gradients
(the fused sparse step, in f32 and bf16, and the routed step with
``--no-tt``), the dropout masks' shapes, the CSR attention's plain version
on edge cases, the refused routes and the CLI flag.

The reference is independent of the program: it takes the self-loop as an
explicit edge and each slot's softmax over a concatenated level, where the
program folds the self-loop in beside the row's edges.  Tolerances: f32
paths agree to f32 reassociation (1e-5 of the reference's norm); bf16
paths store x, the attention result and each activation in bf16 (8 bits of
mantissa, a relative step of 2^-9 a rounding, through three layers), and
their limits lie between the program's readings and those of the
reference in float8 (``CONTROLS["fp8"]``), which they must refuse: on the
train step's seed the bf16 step reads a loss gap of 3.1e-6 and a gradient
difference of 0.006 against the control's 1.8e-3 and 0.11; the bf16
logits 0.006 and 0.025 against the control's ~0.09.
"""

import numpy as np
import pytest
import torch

from falcon_ttdforgnns_torch import cli
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.models import gat_ns
from falcon_ttdforgnns_torch.models.gat_ns import GATNS
from falcon_ttdforgnns_torch.ops.attention import csr_gat, csr_gat_plain
from falcon_ttdforgnns_torch.ops.segment import edges_by_row
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
from falcon_ttdforgnns_torch.train.optim import ADAM_B1
from gnnbench.reference import gat as ref

HEADS, HIDDEN, FEAT = 4, 8, 16
TT = {"p_shapes": [10, 10, 20], "q_shapes": [4, 2, 2], "ranks": [4, 4]}


@pytest.fixture(scope="module")
def ds():
    return hard_synthetic_dataset(num_nodes=2000, avg_degree=8, num_classes=5, feat_dim=FEAT,
                                  seed=3, split_counts=(400, 200, 400))


def config(use_tt=True, dropout=0.5):
    return {"model": {"arch": "gat", "num_layers": 3, "hidden_dim": HIDDEN,
                      "num_heads": HEADS, "feat_dim": FEAT, "dropout": dropout,
                      "fanouts": [2, 3, 4], "batch_size": 16},
            "tt": TT if use_tt else None,
            "trainer": {"lr": 0.001, "num_heads": HEADS, "model": "gat"}}


def trainer_of(ds, seed=7, use_tt=True, hidden=HIDDEN, **kw):
    """A GAT trainer on the CPU with the reference's weights of ``seed``."""
    conf = config(use_tt)
    conf["model"]["hidden_dim"] = hidden
    cfg = TrainConfig(model="gat", num_heads=HEADS, hidden_dim=hidden, num_layers=3,
                      fanouts=(2, 3, 4), batch_size=16, lr=0.001, use_tt=use_tt,
                      tt_ranks=tuple(TT["ranks"]), p_shapes=tuple(TT["p_shapes"]),
                      q_shapes=tuple(TT["q_shapes"]), seed=seed, **kw)
    tr = SageTrainer(ds, cfg, device="cpu")
    weights = ref.make_weights(conf, ds.num_nodes, ds.num_classes, seed, "cpu")
    params = dict(tr.model.named_parameters())
    assert sorted(params) == sorted(weights)
    with torch.no_grad():
        for n, w in weights.items():
            params[n].copy_(w)
    return tr, conf, weights


def gaps(got, want):
    diff = (got.float() - want).norm(dim=1)
    return (float(diff.norm() / want.norm()),
            float(diff.max() / want.norm(dim=1).pow(2).mean().sqrt()))


@pytest.mark.parametrize("bf16,hidden,limits", [(False, HIDDEN, (1e-5, 1e-5)),
                                                (True, HIDDEN, (0.015, 0.06)),
                                                (False, 6, (1e-5, 1e-5))])
def test_full_graph_logits_match_the_reference(ds, bf16, hidden, limits):
    """The evaluate() forward over every in-edge against the reference's
    float32 logits: logit gap (norm of the difference over the reference's)
    and row gap (the worst row's over the rms row).  Heads of 6 values are
    padded to 8 in the projection and dropped after the attention."""
    tr, conf, weights = trainer_of(ds, bf16=bf16, hidden=hidden)
    assert isinstance(tr.model, GATNS)
    with torch.no_grad():
        got = tr.model.forward_full_graph(tr._full_graph())
    g = ds.graph
    want = ref.full_graph_logits(conf, weights, torch.as_tensor(g.indptr),
                                 torch.as_tensor(g.indices))
    assert got.dtype == torch.float32 and got.shape == want.shape
    logit_gap, row_gap = gaps(got, want)
    assert logit_gap <= limits[0] and row_gap <= limits[1], (logit_gap, row_gap)
    accs = tr.evaluate()
    pred, labels = got.argmax(-1), torch.as_tensor(ds.labels)
    assert accs["val_acc"] == pytest.approx(
        float((pred[ds.val_idx] == labels[ds.val_idx]).float().mean()))
    # the layer-wise inference of --save-pred returns the logits evaluated
    assert torch.equal(tr.infer_full(), got)


def keep_masks(masks: list):
    """A stand-in for the model's ``dropout`` that records each keep mask
    from the generator's own draw (``nn.layers.dropout``'s ``rand < 1 - p``,
    the generator's state put back) and then drops as the model does.  The
    nonzeros of the output would misread a kept ELU value that is exactly 0,
    which a bf16 sum of two opposite values is about once in a thousand."""
    inner = gat_ns.dropout

    def drop(h, p, train, generator):
        state = generator.get_state()
        masks.append(torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p)
        generator.set_state(state)
        return inner(h, p, train, generator)
    return drop


def recorded_step(tr, monkeypatch):
    """One train step on the loader's first batch, its dropout masks
    recorded where the model draws them; (batch, masks, loss)."""
    masks = []
    drop = keep_masks(masks)

    monkeypatch.setattr(gat_ns, "dropout", drop)
    batch = next(iter(tr.loader))
    loss, _ = tr.train_step(batch.seeds, batch.layers, batch.labels)
    return batch, masks, float(loss)


def first_grads(tr):
    """Each parameter's first gradient, from Adam's first moment after one
    step, (1 - b1) g: the dense group's and the fused cores'."""
    by_id = {id(p): m for p, m in zip(tr.opt_params, tr.opt_state.m)}
    if tr.tt_opt is not None:
        by_id.update({id(p): m for p, m in zip(tr.cores, tr.tt_opt.m)})
    return {n: by_id[id(p)] / (1.0 - ADAM_B1) for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize("path,kw,loss_tol,grad_tol", [
    ("fused f32", dict(sparse=True), 1e-5, 1e-5),
    ("fused bf16", dict(sparse=True, bf16=True), 2e-4, 0.04),
    ("routed --no-tt", dict(use_tt=False), 1e-5, 1e-5),
])
def test_train_step_matches_the_reference(ds, monkeypatch, path, kw, loss_tol, grad_tol):
    """The first step's loss and every parameter's gradient (the norm of
    the difference over the larger of the reference's norm of that leaf and
    of the median leaf) against the reference repeating the step on the
    same sampled levels and dropout masks."""
    tr, conf, weights = trainer_of(ds, seed=11, **kw)
    assert tr.fused_sparse == (path.startswith("fused"))
    batch, masks, loss = recorded_step(tr, monkeypatch)
    step = {"seeds": torch.as_tensor(batch.seeds), "labels": torch.as_tensor(batch.labels),
            "layers": [torch.as_tensor(l) for l in batch.layers], "masks": masks}
    r = ref.train_readings(conf, weights, [step])
    assert abs(loss - r["losses"][0]) <= loss_tol * r["losses"][0], (loss, r["losses"])
    got = first_grads(tr)
    med = float(np.median(list(r["grad_norms"].values())))
    worst = {n: float((got[n] - g).norm()) / max(r["grad_norms"][n], med)
             for n, g in r["grads"].items()}
    assert max(worst.values()) <= grad_tol, worst


def test_dropout_masks_have_the_reference_shapes(ds, monkeypatch):
    tr, conf, _ = trainer_of(ds, sparse=True)
    batch, masks, _ = recorded_step(tr, monkeypatch)
    B = batch.seeds.shape[0]
    widths = [1] + [np.asarray(l).reshape(B, -1).shape[1] for l in batch.layers]
    assert [tuple(m.shape) for m in masks] == ref.mask_shapes(conf["model"], B, widths)
    assert len(masks) == 5  # layer 0 on levels 0-2, layer 1 on levels 0-1


def csr_case(heads, cp, seed=0):
    """A graph of 60 rows: row 0 without in-edges, row 1 of degree 1,
    row 2 of degree 40 (past a warp's 32 lanes and the kernel's 4 edges in
    flight), the rest 0-6; x (60, heads * cp), el and er with scores of a
    few units, and the edges' row index."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, 60)
    deg[:3] = (0, 1, 40)
    dst = torch.as_tensor(np.repeat(np.arange(60), deg))
    src = torch.as_tensor(rng.integers(0, 60, int(deg.sum())))
    x = torch.as_tensor(rng.normal(size=(60, heads * cp)), dtype=torch.float32)
    el = torch.as_tensor(rng.normal(size=(60, heads)) * 2, dtype=torch.float32)
    er = torch.as_tensor(rng.normal(size=(60, heads)) * 2, dtype=torch.float32)
    return x, el, er, edges_by_row(src, dst, 60)


@pytest.mark.parametrize("mean", [False, True], ids=["heads side by side", "head mean"])
def test_csr_attention_plain_version_against_the_reference(mean):
    x, el, er, index = csr_case(HEADS, 6)
    src, indptr = index.src, index.indptr
    got = csr_gat(x, el, er, index, HEADS, mean)
    assert torch.equal(got, csr_gat_plain(x, el, er, src, indptr, HEADS, mean))
    att = ref.attend_rows(x.reshape(60, HEADS, 6), el, er, indptr, src, edge_chunk=16)
    want = att.mean(1) if mean else att.reshape(60, -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # a row without in-edges is its self-loop alone; one of degree 1 mixes two rows
    def own(v):
        return x[v].reshape(HEADS, 6).mean(0) if mean else x[v]

    torch.testing.assert_close(got[0], own(0), rtol=1e-6, atol=1e-7)
    assert not torch.allclose(got[1], own(1))


def test_csr_attention_plain_version_bf16_and_checks():
    x, el, er, index = csr_case(2, 8, seed=1)
    got = csr_gat(x.bfloat16(), el, er, index, 2, False)
    assert got.dtype == torch.bfloat16
    want = csr_gat_plain(x.bfloat16().float(), el, er, index.src, index.indptr, 2, False)
    assert torch.equal(got, want.bfloat16())
    with pytest.raises(ValueError, match="forward only"):
        csr_gat(x.requires_grad_(True), el, er, index, 2, False)
    with pytest.raises(ValueError):
        csr_gat(x.detach(), el[:, :1], er, index, 2, False)


@pytest.mark.parametrize("kw", [
    dict(node_shard=True), dict(spmm="pallas"), dict(spmm="blocked"),
    dict(eval_sampled=True), dict(use_sample=False), dict(bf16_mean_f32=True),
    dict(bf16_f32_head=True), dict(bf16_f32_first=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_refused_routes(ds, kw):
    with pytest.raises(ValueError, match="sampled GAT"):
        SageTrainer(ds, TrainConfig(model="gat", **kw), device="cpu")


def test_unknown_model_is_refused(ds):
    with pytest.raises(ValueError, match="unknown model"):
        SageTrainer(ds, TrainConfig(model="gin"), device="cpu")


def test_cli_model_gat_ns(tmp_path, monkeypatch):
    """``--model gat-ns`` trains and evaluates the sampled GAT through
    SageTrainer; ``--save-pred`` takes its layer-wise inference."""
    import falcon_ttdforgnns_torch.train as train_pkg
    built = []

    class Recorded(SageTrainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    monkeypatch.setattr(train_pkg, "SageTrainer", Recorded)
    best = cli.main(["--device", "cpu", "--model", "gat-ns", "--num-heads", "2",
                     "--dataset", "hard-ogbn-arxiv", "--synthetic-scale", "0.01",
                     "--epochs", "1", "--num-hidden", "8", "--num-layers", "2",
                     "--fan-out", "3,3", "--batch", "64", "--tt-rank", "4,4", "--sparse",
                     "--save-pred", "--ckpt-dir", str(tmp_path), "--log-dir", str(tmp_path)])
    assert set(best) == {"val_acc", "test_acc", "epoch"}
    (tr,) = built
    assert isinstance(tr.model, GATNS) and tr.cfg.model == "gat" and tr.cfg.num_heads == 2
    pred = np.load(tmp_path / "pred_gat-ns_hard-ogbn-arxiv.npz")
    assert pred["logits"].shape == (tr.ds.num_nodes, tr.ds.num_classes)

"""The port as a whole: the port's SageTrainer against the JAX trainer.

A JAX trainer is built on a tiny hard graph (hidden 16, 2 layers, fan-out
(3, 3), batch 64, ranks (4, 4), dropout 0 — torch and jax dropout bits
differ), its variables are loaded into the port's trainer, and both step
functions take the same host-sampled batches for 3 steps: with --sparse
(each fused core update: Pallas in interpret mode against the plain
versions) and without it (each routed core optimizer), in f32 and with the
bf16 tower.  Then evaluate() on the same weights.  Also: the plateau's
auto-off under bf16, the CLI on the CPU, the device rule, and that the
port never imports JAX.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig

from falcon_ttdforgnns_torch.convert import load_jax_variables
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 0.003
TINY = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2,
            tt_ranks=(4, 4), dropout=0.0, lr=LR, seed=0)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    return hard_synthetic_dataset(**kw), jax_hard(**kw)


def run_both(datasets, sparse, **kw):
    ds, jds = datasets
    jtr = JaxTrainer(jds, JaxConfig(sparse=sparse, steps_per_call=1, **TINY, **kw))
    tr = SageTrainer(ds, TrainConfig(sparse=sparse, **TINY, **kw), device="cpu")
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    losses = []
    for _, b in zip(range(3), tr.loader):
        jtr.variables, jtr.opt_state, jl, _ = jtr._step_fn(
            jtr.variables, jtr.opt_state, jnp.asarray(b.seeds),
            [jnp.asarray(l) for l in b.layers], jnp.asarray(b.labels),
            jax.random.PRNGKey(0))
        loss, acc = tr.train_step(b.seeds, b.layers, b.labels)
        losses.append((float(loss), float(jl)))
        assert 0.0 <= float(acc) <= 1.0
    return jtr, tr, losses


def check_params(jtr, tr):
    """Dense params and cores after 3 Adam steps.  Adam's normalised steps
    turn the f32 reordering error of a near-cancelled gradient element into
    a difference of up to ~1e-3 * lr per step, hence the absolute floor."""
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    ours = dict(tr.model.named_parameters())
    for k in range(len(tr.cores)):
        np.testing.assert_allclose(ours[f"embed.tt_core_{k}"].detach().numpy(),
                                   params["embed"][f"tt_core_{k}"], rtol=1e-4,
                                   atol=3 * 1e-3 * LR)
    for i in range(TINY["num_layers"]):
        np.testing.assert_allclose(ours[f"convs.{i}.lin_self.weight"].detach().numpy(),
                                   params[f"conv_{i}"]["self"]["kernel"].T, rtol=1e-4,
                                   atol=3 * 1e-3 * LR)
        np.testing.assert_allclose(ours[f"convs.{i}.lin_neigh.weight"].detach().numpy(),
                                   params[f"conv_{i}"]["neigh"]["kernel"].T, rtol=1e-4,
                                   atol=3 * 1e-3 * LR)


def test_three_sparse_steps_match_jax(datasets):
    jtr, tr, losses = run_both(datasets, sparse=True)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=1e-5)
    check_params(jtr, tr)
    tt_opt = jax.tree.map(np.asarray, jtr.variables["tt_opt"])
    assert int(tr.tt_opt.count) == int(tt_opt["t"]) == 3
    for k in range(len(tr.cores)):
        for ours, key in ((tr.tt_opt.m[k], f"m_{k}"), (tr.tt_opt.v[k], f"v_{k}")):
            want = tt_opt[key]
            np.testing.assert_allclose(ours.numpy(), want, rtol=1e-3,
                                       atol=1e-3 * np.abs(want).max())
    # evaluate() on the same weights: load the JAX trainer's into the port
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    ours, theirs = tr.evaluate(), jtr.evaluate()
    ds = datasets[0]
    for split, idx in (("train", ds.train_idx), ("val", ds.val_idx), ("test", ds.test_idx)):
        # at most one near-tied argmax may fall the other way
        assert abs(ours[f"{split}_acc"] - theirs[f"{split}_acc"]) <= 1.0 / len(idx) + 1e-7


def test_three_dense_steps_match_jax(datasets):
    jtr, tr, losses = run_both(datasets, sparse=False)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=1e-5)
    check_params(jtr, tr)
    assert tr.tt_opt is None


@pytest.mark.parametrize("sparse", [True, False], ids=["fused", "routed"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rowwise_adagrad"])
def test_three_steps_per_core_optimizer_match_jax(datasets, sparse, opt):
    """--tt-optimizer sgd|adagrad|rowwise_adagrad: fused (tt_fused_sgd /
    tt_fused_adagrad with the fixed lr) and routed (the optax transforms
    with the plateau scale) against the JAX trainer, accumulators too."""
    jtr, tr, losses = run_both(datasets, sparse=sparse, tt_optimizer=opt)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=1e-5)
    check_params(jtr, tr)
    assert tr.tt_opt is None
    assert (tr.tt_acc is None) == (opt == "sgd")
    if sparse and opt != "sgd":
        tt_opt = jax.tree.map(np.asarray, jtr.variables["tt_opt"])
        for k, acc in enumerate(tr.tt_acc):
            want = tt_opt[f"acc_{k}"]
            np.testing.assert_allclose(acc.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
        # load_jax_variables carries the (now nonzero) accumulators over
        fresh = SageTrainer(datasets[0], TrainConfig(sparse=True, tt_optimizer=opt,
                                                     **TINY), device="cpu")
        load_jax_variables(fresh, jax.tree.map(np.asarray, jtr.variables))
        for k, acc in enumerate(fresh.tt_acc):
            np.testing.assert_array_equal(acc.numpy(), tt_opt[f"acc_{k}"])


def test_three_bf16_sparse_steps_match_jax(datasets):
    """--bf16 --bf16-mean-f32 --sparse: with the fan-out means accumulated
    in f32 on both sides, the two bf16 towers round at the same places and
    the steps agree as in f32 (bf16 h_all by round to nearest even, the
    bf16 d_h into the gradient kernel, fused Adam)."""
    jtr, tr, losses = run_both(datasets, sparse=True, bf16=True, bf16_mean_f32=True)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=1e-5)
    check_params(jtr, tr)
    assert tr.h_dtype == torch.bfloat16 and tr.patience == 0


def test_three_certified_bf16_steps_track_jax(datasets):
    """--bf16 --sparse, the certified configuration.  The JAX bf16 mean
    rounds its partial sums in bf16; PyTorch's accumulates in f32 (the port
    does not emulate that).  The gradients then differ at bf16 precision,
    and Adam's sign-like early steps turn a near-zero gradient element of
    the other sign into a difference of up to 2 lr per step.  So: losses
    within 2e-3, and at most 5% of each parameter's elements more than
    0.1 lr apart after 3 steps."""
    jtr, tr, losses = run_both(datasets, sparse=True, bf16=True)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=2e-3)
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    ours = dict(tr.model.named_parameters())
    pairs = [(ours[f"embed.tt_core_{k}"], params["embed"][f"tt_core_{k}"])
             for k in range(len(tr.cores))]
    for i in range(TINY["num_layers"]):
        pairs += [(ours[f"convs.{i}.lin_self.weight"], params[f"conv_{i}"]["self"]["kernel"].T),
                  (ours[f"convs.{i}.lin_neigh.weight"], params[f"conv_{i}"]["neigh"]["kernel"].T)]
    for a, b in pairs:
        off = np.abs(a.detach().numpy() - b)
        assert off.max() <= 3 * 2 * LR + 1e-6
        assert (off > 0.1 * LR).mean() <= 0.05


@pytest.mark.parametrize("kw", [dict(bf16=True), dict(bf16_tower=True)])
def test_plateau_auto_off_under_a_bf16_tower(datasets, kw):
    """Auto patience (-1) is 0 under a bf16 tower (JAX trainer.py:248-259):
    the scale stays 1 whatever the loss does; an explicit patience wins."""
    tr = SageTrainer(datasets[0], TrainConfig(sparse=True, **TINY, **kw), device="cpu")
    assert tr.patience == 0
    for _, b in zip(range(2), tr.loader):
        tr.train_step(b.seeds, b.layers, b.labels)
    assert float(tr.plateau.scale) == 1.0 and int(tr.plateau.plateau_count) == 0
    forced = SageTrainer(datasets[0], TrainConfig(plateau_patience=5, **TINY, **kw),
                         device="cpu")
    assert forced.patience == 5
    assert SageTrainer(datasets[0], TrainConfig(**TINY), device="cpu").patience == 800


def test_sr_steps_and_inert_flag_warnings(datasets, capsys):
    """--bf16 --bf16-sr --sparse trains with a fresh SR seed each step;
    sub-flags set without their base mode warn (JAX trainer.py:200-217)."""
    tr = SageTrainer(datasets[0], TrainConfig(sparse=True, bf16=True, bf16_sr=True,
                                              **TINY), device="cpu")
    states = [tr.sr_gen.get_state()]
    for _, b in zip(range(2), tr.loader):
        assert np.isfinite(float(tr.train_step(b.seeds, b.layers, b.labels)[0]))
        states.append(tr.sr_gen.get_state())
    assert not torch.equal(states[0], states[1]) and not torch.equal(states[1], states[2])
    assert capsys.readouterr().err == ""
    SageTrainer(datasets[0], TrainConfig(bf16_sr=True, bf16_mean_f32=True,
                                         bf16_f32_head=True, **TINY), device="cpu")
    err = capsys.readouterr().err
    for flag in ("--bf16-sr", "--bf16-mean-f32", "--bf16-f32-head"):
        assert flag in err


def test_fit_runs_and_reports(datasets):
    cfg = TrainConfig(epochs=2, sparse=True, log_every=5, **TINY)
    res = SageTrainer(datasets[0], cfg, device="cpu").fit()
    assert len(res["history"]) == 2
    assert np.isfinite(res["history"][-1]["loss"])
    assert 0.0 <= res["best"]["test_acc"] <= 1.0


@pytest.mark.parametrize("kw", [dict(mode="puregpu"), dict(cache_size=8), dict(grouped=True),
                                dict(eval_sampled=True), dict(use_sample=False)])
def test_unported_options_raise(datasets, kw):
    with pytest.raises(NotImplementedError):
        SageTrainer(datasets[0], TrainConfig(**{**TINY, **kw}), device="cpu")


def test_cuda_requested_without_a_card_raises(datasets):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        SageTrainer(datasets[0], TrainConfig(**TINY))  # the default device is cuda


def test_cli_runs_on_cpu(capsys, tmp_path):
    from falcon_ttdforgnns_torch import cli
    common = ["--device", "cpu", "--dataset", "hard-ogbn-arxiv", "--synthetic-scale",
              "0.01", "--num-hidden", "16", "--num-layers", "2", "--fan-out", "3,3",
              "--batch", "64", "--tt-rank", "4,4", "--sparse", "--log-dir", str(tmp_path)]
    cli.main(common + ["--epochs", "1"])
    assert '"best"' in capsys.readouterr().out
    cli.main(common + ["--run-one"])
    cli.main(common + ["--model", "gcn", "--run-one"])  # full-graph GCN runs through the CLI
    with pytest.raises(ValueError):  # the tiled SpMM is SAGE evaluation's, as in JAX
        cli.main(common + ["--model", "gcn", "--spmm", "pallas"])


@pytest.mark.parametrize("spmm", ["pallas", "blocked"])
def test_evaluate_spmm_routes_match_xla_and_jax(datasets, spmm):
    """evaluate() through the tiled (B7) and the blocked (B9) SpMM, on the
    CPU their plain versions, gives the xla route's accuracies and the JAX
    trainer's (its pallas route is the XLA one off a TPU; its blocked route
    runs Pallas in interpret mode): at most one near-tied argmax apart.
    The tiled aggregate itself is held to the Pallas kernel in interpret
    mode on the same graph (1e-5 of the largest value)."""
    from falcon_ttdforgnns_tpu.ops import spmm_pallas as JP
    ds, jds = datasets
    jtr = JaxTrainer(jds, JaxConfig(spmm=spmm, steps_per_call=1, **TINY))
    variables = jax.tree.map(np.asarray, jtr.variables)
    xla = SageTrainer(ds, TrainConfig(**TINY), device="cpu")
    tr = SageTrainer(ds, TrainConfig(spmm=spmm, **TINY), device="cpu")
    for t in (xla, tr):
        load_jax_variables(t, variables)
    ours, base, theirs = tr.evaluate(), xla.evaluate(), jtr.evaluate()
    for split, idx in (("train", ds.train_idx), ("val", ds.val_idx), ("test", ds.test_idx)):
        for other in (base, theirs):
            assert abs(ours[f"{split}_acc"] - other[f"{split}_acc"]) <= 1.0 / len(idx) + 1e-7
    assert tr.full_graph_spmm(spmm).info["chunks"] >= 1
    if spmm == "pallas":
        src, dst = ds.graph.to_coo()
        tu = JP.build_spmm_tiles_uniform(src.astype(np.int32), dst, ds.num_nodes,
                                         tile_edges=tr.full_graph_spmm("pallas").meta[3],
                                         tiles_per_chunk=256)
        h = np.random.default_rng(0).normal(size=(ds.num_nodes, 16)).astype(np.float32)
        want = JP.spmm_sum_tiled_uniform(
            jnp.asarray(h), jnp.asarray(tu.src), jnp.asarray(tu.dstl), jnp.asarray(tu.w),
            jnp.asarray(tu.blkl), jnp.asarray(tu.first), jnp.asarray(tu.blk0),
            tu.num_blocks_padded, tu.blocks_per_chunk, tu.block_rows, tu.tile_edges,
            ds.num_nodes, interpret=True)
        got = tr.full_graph_spmm("pallas")(torch.tensor(h)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("spmm", ["xla", "blocked"])
def test_infer_full_matches_jax(datasets, spmm):
    """Layer-wise inference (chunked materialise, one conv per layer over
    the full graph) against the JAX trainer's infer_full: logits within
    1e-5 of the largest."""
    ds, jds = datasets
    kw = dict(TINY, spmm=spmm, inference_chunk=300)
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **kw))
    tr = SageTrainer(ds, TrainConfig(**kw), device="cpu")
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    want = jtr.infer_full()
    got = tr.infer_full().numpy()
    assert got.shape == (ds.num_nodes, ds.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_port_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax, optax or
    the JAX package; importing the trainer leaves jax out of sys.modules."""
    banned = ("jax", "flax", "optax", "falcon_ttdforgnns_tpu")
    files = sorted((REPO / "falcon_ttdforgnns_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in banned, f"{f} imports {n}"
    code = ("import sys, falcon_ttdforgnns_torch.train.trainer, falcon_ttdforgnns_torch.cli; "
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'falcon_ttdforgnns_tpu') for m in sys.modules), 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)

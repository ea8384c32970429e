"""The slice as a whole: the port's SageTrainer against the JAX trainer.

A JAX trainer is built on a tiny hard graph (hidden 16, 2 layers, fan-out
(3, 3), batch 64, ranks (4, 4), dropout 0 — torch and jax dropout bits
differ), its variables are loaded into the port's trainer, and both step
functions take the same host-sampled batches for 3 steps, with --sparse
(fused Adam: Pallas in interpret mode against the plain versions) and
without it.  Then evaluate() on the same weights.  Also: the CLI on the
CPU, the device rule, and that the port never imports JAX.
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


def run_both(datasets, sparse):
    ds, jds = datasets
    jtr = JaxTrainer(jds, JaxConfig(sparse=sparse, steps_per_call=1, **TINY))
    tr = SageTrainer(ds, TrainConfig(sparse=sparse, **TINY), device="cpu")
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


def test_fit_runs_and_reports(datasets):
    cfg = TrainConfig(epochs=2, sparse=True, log_every=5, **TINY)
    res = SageTrainer(datasets[0], cfg, device="cpu").fit()
    assert len(res["history"]) == 2
    assert np.isfinite(res["history"][-1]["loss"])
    assert 0.0 <= res["best"]["test_acc"] <= 1.0


@pytest.mark.parametrize("kw", [dict(mode="puregpu"), dict(cache_size=8), dict(bf16=True),
                                dict(tt_optimizer="sgd"), dict(spmm="pallas")])
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
    with pytest.raises(NotImplementedError):
        cli.main(common + ["--model", "gcn"])


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

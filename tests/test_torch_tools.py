"""The port's single-card tools against the JAX package's: the evaluator,
the ES rank tuner's history, the metrics helpers, the profiler harness'
generator and forward check, and tiny CLI runs of ``--store-emb`` (rows
equal to JAX's ``materialize_features`` from the same cores),
``--profile``, ``--plot``, ``--autotune`` and ``--eval-sampled`` on the
CPU.  What times the card (``device_timing``, the benchmarks) raises here.
"""

import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu import profiler as jax_profiler
from falcon_ttdforgnns_tpu.models.sage import SAGE as JaxSAGE
from falcon_ttdforgnns_tpu.utils import evaluator as jax_evaluator
from falcon_ttdforgnns_tpu.utils import metrics as jax_metrics
from falcon_ttdforgnns_tpu.utils import tuner as jax_tuner

from falcon_ttdforgnns_torch import cli, profiler
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
from falcon_ttdforgnns_torch.utils import evaluator, metrics, tuner

TINY_CLI = ["--device", "cpu", "--dataset", "hard-ogbn-arxiv", "--synthetic-scale", "0.01",
            "--epochs", "1", "--num-hidden", "16", "--num-layers", "2", "--fan-out", "3,3",
            "--batch", "64", "--tt-rank", "4,4"]


def test_evaluator_matches_jax():
    rng = np.random.default_rng(0)
    pred, true = rng.integers(0, 5, 300), rng.integers(0, 5, 300)
    for name in ("acc", "f1", "f1-micro", "ogb"):
        assert evaluator.get_evaluator(name, "ogbn-products")(pred, true) == \
            jax_evaluator.get_evaluator(name, "ogbn-products")(pred, true)
    assert evaluator.f1_score(pred, true, "weighted") == jax_evaluator.f1_score(
        pred, true, "weighted")
    assert evaluator.get_evaluator("ogb")(pred, true) == evaluator.accuracy(pred, true)
    with pytest.raises(ValueError):
        evaluator.get_evaluator("auc")


@pytest.mark.parametrize("budget,seed", [(7, 0), (12, 3)])
def test_es_tuner_history_is_jax(budget, seed):
    """One deterministic objective and seed: the same candidates in the
    same order, the same best."""
    def objective(p):
        return (math.log(p["r1"]) - 3.1) ** 2 + (math.log(p["r2"]) - 4.2) ** 2

    space = {"r1": (2, 256), "r2": (2, 256)}
    ours = tuner.minimize(objective, space, budget, seed, engine="es")
    want = jax_tuner.minimize(objective, space, budget, seed, engine="es")
    assert ours.history == want.history and len(ours.history) == budget
    assert (ours.best_params, ours.best_value) == (want.best_params, want.best_value)
    seen = []
    res = tuner.tune_tt_rank(lambda r: seen.append(r) or 100.0 * r[0], budget=3, seed=seed,
                             engine="es")
    assert seen[0] == (23, 23) and res.best_value == pytest.approx(1 / (100.0 * max(
        r[0] for r in seen)))


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    counts = rng.zipf(1.5, 1000)
    degrees = rng.integers(0, 500, 2000)
    ids = rng.integers(0, 50, 400)
    assert metrics.edges_per_second(10, 4.0) == jax_metrics.edges_per_second(10, 4.0)
    for a, b in zip(metrics.degree_histogram(degrees), jax_metrics.degree_histogram(degrees)):
        np.testing.assert_array_equal(a, b)
    assert metrics.count_nnz(ids) == jax_metrics.count_nnz(ids)
    assert metrics.max_batch_size(1000, 100, 256, (5, 10, 15), device_bytes=16 << 30) == \
        jax_metrics.max_batch_size(1000, 100, 256, (5, 10, 15), hbm_bytes=16 << 30)
    assert metrics.access_percentages(counts) == jax_metrics.access_percentages(counts)
    path = str(tmp_path / "cdf.png")
    drawn = metrics.plot_access_cdf(counts, path)
    assert drawn == os.path.exists(path)
    assert metrics.plot_degree_distribution(degrees, str(tmp_path / "deg.png")) == drawn


def test_device_metrics_without_a_card(tmp_path, monkeypatch):
    """No card here: device_timing raises rather than time the CPU, the
    memory stats are empty, max_batch_size needs the bytes; profile_trace
    writes a Chrome trace that names the ops it saw, and the span table."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError):
        metrics.device_timing(lambda: None, device="cpu")
    assert metrics.device_memory_stats() == {}
    with pytest.raises(ValueError):
        metrics.max_batch_size(10, 8, 8, (2,))
    with metrics.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (trace,) = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert any("matmul" in e.get("name", "") for e in json.load(open(trace))["traceEvents"])
    (table,) = glob.glob(str(tmp_path / "prof" / "spans_*.json"))
    assert json.load(open(table)) == {}
    with metrics.profile_trace(None):
        pass


def test_profiler_harness_on_the_cpu():
    got = profiler.generate_sparse_feature(50, 1000, seed=3)
    want = jax_profiler.generate_sparse_feature(50, 1000, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    bench = profiler.TTEmbeddingBenchmark(batch_size=300, p_shapes=(6, 8, 10),
                                          q_shapes=(2, 2, 3), ranks=(4, 5), device="cpu")
    jbench = jax_profiler.TTEmbeddingBenchmark(batch_size=300, p_shapes=(6, 8, 10),
                                               q_shapes=(2, 2, 3), ranks=(4, 5))
    np.testing.assert_array_equal(bench.idx.numpy(), np.asarray(jbench.idx))
    for a, b in zip(bench.cores, jbench.cores):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bench.check_forward() < 1e-5
    with pytest.raises(ValueError):
        bench.bench_forward()  # times the card only


def test_profile_training_step_writes_a_trace(tmp_path):
    ds = hard_synthetic_dataset(num_nodes=800, avg_degree=4, num_classes=3, feat_dim=8, seed=0)
    tr = SageTrainer(ds, TrainConfig(batch_size=32, fanouts=(2, 2), hidden_dim=8,
                                     num_layers=2, tt_ranks=(2, 2)), device="cpu")
    profiler.profile_training_step(tr, str(tmp_path), steps=2)
    assert len(glob.glob(str(tmp_path / "trace_*.json"))) == 1
    assert len(glob.glob(str(tmp_path / "spans_*.json"))) == 1


def test_cli_store_emb_rows_are_jax_rows(tmp_path):
    """--store-emb after an epoch (and --save-model): the stored table is
    what the JAX SAGE's materialize_features gives from the checkpoint's
    cores (f32 chains in another order: 1e-5 relative)."""
    ck = tmp_path / "ck"
    cli.main(TINY_CLI + ["--store-emb", "--save-model", "--ckpt-dir", str(ck),
                         "--log-dir", str(tmp_path / "logs")])
    (emb_path,) = glob.glob(str(ck / "emb_approx-normal_tt4_part0.npy"))
    emb = np.load(emb_path)
    (ckpt,) = glob.glob(str(ck / "step_*.pt"))
    state = torch.load(ckpt, weights_only=True)["variables"]["model"]
    cores = tuple(state[f"embed.tt_core_{k}"].numpy() for k in range(3))
    n, d = emb.shape
    jm = JaxSAGE(num_nodes=n, in_dim=d, hidden_dim=16, num_classes=40, num_layers=2,
                 tt_ranks=(4, 4), p_shapes=(50, 60, 60), q_shapes=(8, 4, 4))  # arxiv preset
    params = {"embed": {f"tt_core_{k}": jnp.asarray(c) for k, c in enumerate(cores)}}
    want = np.asarray(jm.apply({"params": params}, jnp.arange(n, dtype=jnp.int32),
                               method=JaxSAGE.materialize_features))
    np.testing.assert_allclose(emb, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_cli_profile_plot_and_eval_sampled(tmp_path, capsys):
    prof, logs = tmp_path / "prof", tmp_path / "logs"
    best = cli.main(TINY_CLI + ["--eval-sampled", "--eval-sample-max", "200", "--profile",
                                "--profile-dir", str(prof), "--plot", "--access-counts",
                                "--log-dir", str(logs)])
    assert set(best) == {"val_acc", "test_acc", "epoch"}
    assert len(glob.glob(str(prof / "trace_*.json"))) == 1
    assert len(glob.glob(str(prof / "spans_*.json"))) == 1
    assert os.path.exists(logs / "access_cdf.png") == (metrics._pyplot() is not None)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best"] == best


def test_cli_autotune(tmp_path, capsys):
    assert cli.main(TINY_CLI + ["--autotune", "--tune-budget", "2",
                                "--log-dir", str(tmp_path)]) is None
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"best_ranks", "objective"} and out["objective"] > 0
    assert set(out["best_ranks"]) == {"r1", "r2"}

"""The embedding modules other than TTEmbeddingBag, and the trainers'
``--no-tt`` and ``--access-counts`` paths, against the JAX package on the
CPU.  The JAX modules' variables are carried into the port by
``convert.embedding_state_from_jax`` (``load_jax_variables`` and
``full_graph_state_from_jax`` for the trainers).  Tolerances: the lookups
gather, so the rows are equal bit for bit; the TT lookups and the pooled
sums (f32 sums in another order) within 1e-6 relative; 3 --no-tt steps,
TF32 off: losses within 1e-5 relative, parameters within 1e-4 relative
plus 3e-3 lr (Adam's normalised step on a near-cancelled gradient
element); access counts exactly.  Also tests/test_models.py's dense,
fixed-feature and table-batched cases and tests/test_cli.py's --no-tt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401 (a fixture)

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.nn import tt_embedding as jemb
from falcon_ttdforgnns_tpu.train import FullGraphConfig as JFullConfig
from falcon_ttdforgnns_tpu.train import FullGraphTrainer as JFullTrainer
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig

from falcon_ttdforgnns_torch.convert import (embedding_state_from_jax,
                                             full_graph_state_from_jax, load_jax_variables)
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset, synthetic_dataset
from falcon_ttdforgnns_torch.models.sage import SAGE, make_embed_layer
from falcon_ttdforgnns_torch.nn import (AccessCountingEmbedding, DenseEmbedding,
                                        FixedFeatureEmbedding, TableBatchedTTEmbeddingBag,
                                        TTEmbeddingBag)
from falcon_ttdforgnns_torch.train import (FullGraphConfig, FullGraphTrainer, SageTrainer,
                                           TrainConfig)
from falcon_ttdforgnns_torch.utils import metrics as M

N, D = 300, 12
LR = 0.003


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ids_and_offsets(shape=(40,), seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, shape).astype(np.int32)
    ids.reshape(-1)[:5] = ids.reshape(-1)[5:10]  # repeated ids
    cuts = np.sort(rng.choice(np.arange(1, shape[-1]), 7, replace=False))
    return ids, np.concatenate([[0], cuts, [shape[-1]]]).astype(np.int32)


def jax_vars(module, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(3), *args))


def port(module, variables):
    module.load_state_dict(embedding_state_from_jax(variables), strict=True)
    return module


@pytest.mark.parametrize("pooled", [False, True], ids=["rows", "bags"])
@pytest.mark.parametrize("kind", ["dense", "counting", "fixed"])
def test_modules_match_jax(kind, pooled):
    """The dense table, the access-counting table (rows and counts after a
    counting call) and the frozen features, with and without offsets."""
    ids, offs = ids_and_offsets()
    feats = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    jm, tm = {"dense": (jemb.DenseEmbedding(N, D), DenseEmbedding(N, D)),
              "counting": (jemb.AccessCountingEmbedding(N, D), AccessCountingEmbedding(N, D)),
              "fixed": (jemb.FixedFeatureEmbedding(feats), FixedFeatureEmbedding(np.zeros((N, D))))
              }[kind]
    jargs = (jnp.asarray(ids), jnp.asarray(offs) if pooled else None)
    variables = jax_vars(jm, *jargs)
    port(tm, variables)
    if kind == "counting":
        want, upd = jm.apply(jax.tree.map(jnp.asarray, variables), *jargs, True,
                             mutable=["access_counts"])
        np.testing.assert_array_equal(
            np.asarray(upd["access_counts"]["counts"]),
            np.bincount(ids, minlength=N))
    else:
        want = jm.apply(variables, *jargs)
    got = tm(torch.tensor(ids), torch.tensor(offs) if pooled else None)
    if pooled:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    if kind == "counting":
        np.testing.assert_array_equal(tm.counts.numpy(),
                                      np.asarray(upd["access_counts"]["counts"]))
        tm(torch.tensor(ids), count_accesses=False)  # an evaluate's lookup counts nothing
        np.testing.assert_array_equal(tm.counts.numpy(), np.bincount(ids, minlength=N))
    if kind == "fixed":
        assert "params" not in variables and not list(tm.parameters())


@pytest.mark.parametrize("pooled", [False, True], ids=["rows", "bags"])
@pytest.mark.parametrize("tables", [1, 3])
def test_table_batched_matches_jax(tables, pooled):
    """(T, B) ids -> (T, B, D): the port's own init draws the JAX module's
    per-table cores; one table keeps the cache (tables.*), several do not."""
    ids, offs = ids_and_offsets((tables, 40))
    offs = np.tile(offs, (tables, 1))
    jm = jemb.TableBatchedTTEmbeddingBag(num_tables=tables, num_embeddings=N, embedding_dim=D,
                                         tt_ranks=(4, 4), weight_dist="normal", cache_size=16)
    jargs = (jnp.asarray(ids), jnp.asarray(offs) if pooled else None)
    variables = jax_vars(jm, *jargs)
    want = jm.apply(variables, *jargs, mutable=["ttcache"])[0]
    tm = TableBatchedTTEmbeddingBag(tables, N, D, (4, 4), weight_dist="normal", cache_size=16)
    own = {k: v.clone() for k, v in tm.state_dict().items()}
    for k, v in embedding_state_from_jax({"params": variables["params"]}).items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy())  # the same init
    got = tm(torch.tensor(ids), torch.tensor(offs) if pooled else None)
    assert got.shape == (tables, offs.shape[1] - 1 if pooled else 40, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    assert ("ttcache" in variables) == (tables == 1)
    assert hasattr(tm, "tables") == (tables == 1)
    if tables > 1:
        assert tm.tt_core_0.shape[0] == tables
        same = tm(torch.zeros((tables, 4), dtype=torch.int32))
        assert not torch.allclose(same[0], same[1])


def test_make_embed_layer_order():
    """JAX's order: frozen features, then TT, then the counting table, then
    the dense one."""
    feats = np.ones((N, D), np.float32)
    assert isinstance(make_embed_layer(N, D, fixed_features=feats), FixedFeatureEmbedding)
    assert isinstance(make_embed_layer(N, D, True, (4, 4), access_counts=True), TTEmbeddingBag)
    assert isinstance(make_embed_layer(N, D, False, access_counts=True),
                      AccessCountingEmbedding)
    assert isinstance(make_embed_layer(N, D, False), DenseEmbedding)
    w = make_embed_layer(N, D, False, generator=torch.Generator().manual_seed(0)).weight
    assert abs(float(w.detach().std()) - 0.1) < 0.01


# ------------------------------------------------------------ the trainers
@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    return hard_synthetic_dataset(**kw), jax_hard(**kw)


TINY = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2, dropout=0.0,
            lr=LR, seed=0, use_tt=False)


def check_close(ours: torch.Tensor, want, what: str):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(want), rtol=1e-4,
                               atol=3 * 1e-3 * LR, err_msg=what)


@pytest.mark.parametrize("counts", [False, True], ids=["dense", "access-counts"])
def test_three_no_tt_steps_match_jax(datasets, counts):
    """--no-tt (and --access-counts) SAGE: 3 sampled f32 steps from the same
    variables on the same batches; the table and the convs after routed
    Adam; the access counts exactly; then access_count_stats'
    percentages."""
    ds, jds = datasets
    kw = dict(TINY, access_counts=counts)
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **kw))
    tr = SageTrainer(ds, TrainConfig(**kw), device="cpu")
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    assert not tr.cores and not tr.fused_sparse
    for _, b in zip(range(3), tr.loader):
        jtr.variables, jtr.opt_state, jl, _ = jtr._step_fn(
            jtr.variables, jtr.opt_state, jnp.asarray(b.seeds),
            [jnp.asarray(l) for l in b.layers], jnp.asarray(b.labels), jax.random.PRNGKey(0))
        loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
        assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    table = params["embed"]["table"]["weight"] if counts else params["embed"]["weight"]
    ours = dict(tr.model.named_parameters())
    check_close(ours["embed.table.weight" if counts else "embed.weight"], table, "table")
    for i in range(2):
        check_close(ours[f"convs.{i}.lin_self.weight"], params[f"conv_{i}"]["self"]["kernel"].T,
                    f"conv {i}")
    if counts:
        want = np.asarray(jtr.variables["access_counts"]["embed"]["counts"])
        np.testing.assert_array_equal(tr.model.embed.counts.numpy(), want)
        assert tr.access_count_stats()["percentages"] == jtr.access_count_stats()["percentages"]
    else:
        assert tr.access_count_stats() is None


def test_access_count_stats_from_the_loader_match_jax(jax_native, datasets):
    """With TT, --access-counts has the host loader count (the JAX loader
    always does): an epoch of the same batches gives the same counts and
    percentages."""
    ds, jds = datasets
    kw = dict(TINY, use_tt=True, tt_ranks=(4, 4))
    tr = SageTrainer(ds, TrainConfig(**kw, access_counts=True), device="cpu")
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **kw))
    for loader in (tr.loader, jtr.loader):
        for _ in loader:
            pass
    np.testing.assert_array_equal(tr.loader.freq, jtr.loader.freq)
    assert tr.loader.freq.sum() == len(tr.loader) * 64 * (1 + 3 + 9)
    assert tr.access_count_stats()["percentages"] == jtr.access_count_stats()["percentages"]


def test_metrics_match_jax():
    from falcon_ttdforgnns_tpu.utils import metrics as JM
    counts = np.random.default_rng(0).zipf(1.5, 1000)
    for a, b in zip(M.cumulative_access_curve(counts), JM.cumulative_access_curve(counts)):
        np.testing.assert_array_equal(a, b)
    assert M.access_percentages(counts) == JM.access_percentages(counts)
    params = [torch.zeros(100, 10), torch.zeros(5, dtype=torch.int32)]
    assert M.model_size_mb(params) == pytest.approx(
        JM.model_size_mb({"a": jnp.zeros((100, 10)), "b": jnp.zeros(5, jnp.int32)}))


def test_no_tt_gcn_steps_match_jax(datasets):
    """Full-graph GCN over the dense table: 3 warmup-AdamW steps (one an
    epoch), dropout 0, then evaluate()."""
    kw = dict(num_nodes=500, avg_degree=6, num_classes=4, feat_dim=16, seed=1)
    ds, jds = hard_synthetic_dataset(**kw), jax_hard(**kw)
    base = dict(epochs=3, lr=0.005, hidden_dim=16, num_layers=3, dropout=0.0,
                warmup_epochs=3, seed=0, model="gcn", use_tt=False)
    jtr = JFullTrainer(jds, JFullConfig(**base))
    tr = FullGraphTrainer(ds, FullGraphConfig(**base), device="cpu")
    tr.model.load_state_dict(full_graph_state_from_jax(jax.tree.map(np.asarray, jtr.variables)))
    for e in range(3):
        assert tr.train_epoch(e)["loss"] == pytest.approx(jtr.train_epoch(e)["loss"], rel=1e-5)
    want = full_graph_state_from_jax(jax.tree.map(np.asarray, jtr.variables))
    ours = tr.model.state_dict()
    assert "embed.weight" in ours and set(ours) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(ours[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=max(1e-4 * float(w.abs().max()) if "running" in k
                                            else 0.0, 3 * 1e-3 * 0.005), err_msg=k)
    tr.model.load_state_dict(want)
    assert tr.evaluate() == jtr.evaluate()


def test_dense_baseline_fits():
    """tests/test_models.py's dense baseline: one epoch with evaluate, a
    finite loss."""
    ds = synthetic_dataset(num_nodes=600, avg_degree=6, num_classes=5, feat_dim=24, seed=0)
    cfg = TrainConfig(batch_size=64, fanouts=(4, 4), epochs=1, hidden_dim=32, num_layers=2,
                      use_tt=False, eval_every=1, log_every=1000)
    result = SageTrainer(ds, cfg, device="cpu").fit()
    assert np.isfinite(result["history"][0]["loss"])
    assert 0.0 <= result["best"]["test_acc"] <= 1.0


def test_sage_with_fixed_features():
    """SAGE's lookup through frozen features: the logits take the features'
    rows (nothing trainable in the embedding)."""
    feats = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    model = SAGE(N, D, 8, 3, num_layers=1, dropout=0.0)
    model.embed = make_embed_layer(N, D, fixed_features=feats)
    seeds = torch.tensor([3, 7, 3])
    layers = [torch.tensor([[1, 2], [3, 4], [5, 6]])]
    logits = model(seeds, layers)
    want = model.convs[0](torch.tensor(feats[[3, 7, 3]])[:, None],
                          torch.tensor(feats[[[1, 2], [3, 4], [5, 6]]]).mean(1)[:, None])
    torch.testing.assert_close(logits, want[:, 0], rtol=1e-6, atol=1e-6)
    assert not [n for n, _ in model.named_parameters() if n.startswith("embed.")]


def test_cli_no_tt_and_emb_name_dense(tmp_path, capsys):
    """tests/test_cli.py's --no-tt, run: --no-tt and --emb-name dense each
    train the dense table, with --access-counts logging the skew."""
    from falcon_ttdforgnns_torch.cli import main
    from falcon_ttdforgnns_torch.utils.config import parse_args
    assert not parse_args(["--no-tt"]).use_tt
    for flag in (["--no-tt", "--access-counts"], ["--emb-name", "dense"]):
        main(["--device", "cpu", "--dataset", "tiny-test", "--synthetic-scale", "1.0",
              "--batch", "32", "--fan-out", "3,3", "--num-hidden", "16", "--num-layers", "2",
              "--epochs", "1", "--log-dir", str(tmp_path), *flag])
        assert '"best"' in capsys.readouterr().out

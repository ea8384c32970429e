"""The LFU hot-row cache (``ops/cache.py``), the cache's trainer lifecycle
and ``--emb-name eff`` against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  Counts,
id tables and ready flags must be identical; rows, gradients and
parameters agree in f32 within the tolerance each test states.  The
trainer tests run the JAX trainer's step function and the port's
train_step on the same host-sampled batches (tiny graph, dropout 0):
three warmup steps, the populate, three cached steps.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.ops import tt_shapes as jax_tt_shapes
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig
from falcon_ttdforgnns_tpu.utils import metrics as jax_metrics

from falcon_ttdforgnns_torch.convert import load_jax_variables
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.models.sage import collect_level_ids
from falcon_ttdforgnns_torch.nn.tt_embedding import TTEmbeddingBag
from falcon_ttdforgnns_torch.ops import cache
from falcon_ttdforgnns_torch.ops import tt_lookup as T
from falcon_ttdforgnns_torch.ops.tt_shapes import make_tt_shapes
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
from falcon_ttdforgnns_torch.utils.metrics import access_percentages

jcache = importlib.import_module("falcon_ttdforgnns_tpu.ops.cache")

LR = 0.003
TINY = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2,
            tt_ranks=(4, 4), dropout=0.0, lr=LR, seed=0)
N, D, K = 3000, 16, 256


def shapes_and_cores(seed=0):
    """A 3-core table of 3000 rows, D=16, ranks (4, 4), cores ~N(0, 1) so
    rows are O(1); the JAX package's shapes beside the port's."""
    shapes = make_tt_shapes(N, D, (4, 4), None, None)
    jshapes = jax_tt_shapes.make_tt_shapes(N, D, (4, 4), None, None)
    rng = np.random.default_rng(seed)
    cores = [rng.normal(size=shapes.core_shape(k)).astype(np.float32)
             for k in range(shapes.ndim)]
    return shapes, jshapes, cores


def tied_freq(seed, n=N, top=40):
    """Counts whose K-th place falls inside a long run of equal counts:
    small integers, most of them tied, a few large, many zero."""
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 4, n).astype(np.int32)
    freq[rng.choice(n, top, replace=False)] = rng.integers(5, 9, top)
    return freq


def jmeta_of(freq, k=K):
    m = jcache.init_meta(len(freq), k)
    return m._replace(freq=jnp.asarray(freq))


def meta_of(freq, k=K):
    m = cache.init_meta(len(freq), k)
    m.freq.copy_(torch.tensor(freq))
    return m


def test_init_meta_update_freq_and_reset():
    ours, ref = cache.init_meta(N, K), jcache.init_meta(N, K)
    for a, b in zip(ours, ref):
        assert a.dtype == {jnp.int32: torch.int32, jnp.bool_: torch.bool}[b.dtype.type]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = np.random.default_rng(0).integers(0, N, 5000).astype(np.int32)  # duplicates
    cache.update_freq(ours, torch.tensor(ids))
    ref = jcache.update_freq(ref, jnp.asarray(ids))
    np.testing.assert_array_equal(ours.freq.numpy(), np.asarray(ref.freq))


@pytest.mark.parametrize("seed,k", [(0, K), (1, K), (2, 100), (3, 2900)])
def test_top_ids_order_among_ties_is_jax_top_k(seed, k):
    """The stable descending sort picks the ids jax.lax.top_k picks: counts
    descending, the lower id first among equals; -1 for zero counts (K=2900
    reaches past the nonzero counts)."""
    freq = tied_freq(seed)
    top_f, top_i = jax.lax.top_k(jnp.asarray(freq), k)
    want = np.where(np.asarray(top_f) > 0, np.asarray(top_i), -1)
    got = cache.top_ids(torch.tensor(freq), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (freq == freq[want[k - 1]]).sum() > 1 or want[k - 1] == -1  # a tie at the K-th place


@pytest.mark.parametrize("seed", [0, 1])
def test_populate_matches_jax(seed):
    """Identical id table (sorted, -1 first) and ready flag; rows within
    1e-5 of max|row| (the plain chain against JAX's, f32)."""
    shapes, jshapes, cores = shapes_and_cores(seed)
    freq = tied_freq(seed)
    freq[:300] = 0  # some ids never seen
    meta, weight = cache.populate(shapes, [torch.tensor(c) for c in cores], meta_of(freq), K,
                                  chunk=100)
    jmeta, jweight = jcache.populate(jshapes, [jnp.asarray(c) for c in cores],
                                     jmeta_of(freq), K, chunk=100)
    np.testing.assert_array_equal(meta.ids.numpy(), np.asarray(jmeta.ids))
    np.testing.assert_array_equal(meta.freq.numpy(), np.asarray(jmeta.freq))
    assert bool(meta.ready) and bool(jmeta.ready)
    jw = np.asarray(jweight)
    np.testing.assert_allclose(weight.numpy(), jw, rtol=1e-5, atol=1e-5 * np.abs(jw).max())
    # and the rows are the TT rows of the cached ids; empty slots are zero
    ids = meta.ids.numpy()
    want = T.tt_lookup_gather(shapes, [torch.tensor(c) for c in cores],
                              torch.tensor(np.maximum(ids, 0))).numpy()
    np.testing.assert_array_equal(weight.numpy()[ids >= 0], want[ids >= 0])


def test_populate_with_fewer_seen_ids_than_slots():
    shapes, jshapes, cores = shapes_and_cores(2)
    freq = np.zeros(N, np.int32)
    freq[[5, 17, 2999]] = [3, 1, 3]
    meta, weight = cache.populate(shapes, [torch.tensor(c) for c in cores], meta_of(freq), 8)
    jmeta, _ = jcache.populate(jshapes, [jnp.asarray(c) for c in cores], jmeta_of(freq, 8), 8)
    np.testing.assert_array_equal(meta.ids.numpy(), np.asarray(jmeta.ids))
    assert meta.ids.tolist() == [-1] * 5 + [5, 17, 2999]
    assert float(weight[:5].abs().sum()) == 0.0


def test_lookup_before_ready_hits_nothing_then_matches_jax():
    shapes, jshapes, cores = shapes_and_cores(3)
    freq = tied_freq(3)
    ids = np.random.default_rng(4).integers(0, N, 2000).astype(np.int32)
    # before the first populate: ids all -1 and ready False
    hit, _ = cache.lookup(cache.init_meta(N, K), torch.tensor(ids))
    assert not bool(hit.any())
    meta, _ = cache.populate(shapes, [torch.tensor(c) for c in cores], meta_of(freq), K)
    jmeta, _ = jcache.populate(jshapes, [jnp.asarray(c) for c in cores], jmeta_of(freq), K)
    # a table that is filled but not ready hits nothing either
    hit, _ = cache.lookup(meta._replace(ready=torch.zeros((), dtype=torch.bool)),
                          torch.tensor(ids))
    assert not bool(hit.any())
    tt_idx, hit, slot = cache.split_indices(meta, torch.tensor(ids))
    jtt, jhit, jslot = jcache.split_indices(jmeta, jnp.asarray(ids))
    assert 0 < int(hit.sum()) < len(ids)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tt_idx.numpy(), np.asarray(jtt))
    assert tt_idx.dtype == torch.int32 and bool((tt_idx[hit] == 0).all())


def test_cached_forward_values_and_gradients_match_jax():
    """The select and its two gradients: the hits' rows to cache_weight
    (index_add_ of the positions' gradients, summed over duplicates, within
    1e-6 of the largest, f32 reordering), zero rows to the TT path."""
    rng = np.random.default_rng(5)
    B = 4000
    w = rng.normal(size=(K, D)).astype(np.float32)
    rows = rng.normal(size=(B, D)).astype(np.float32)
    hit = rng.random(B) < 0.4
    slot = rng.integers(0, K, B)
    g = rng.normal(size=(B, D)).astype(np.float32)

    def jloss(w_, r_):
        return jnp.sum(jcache.cached_forward(w_, r_, jnp.asarray(hit), jnp.asarray(slot)) * g)

    jv = jcache.cached_forward(jnp.asarray(w), jnp.asarray(rows), jnp.asarray(hit),
                               jnp.asarray(slot))
    jgw, jgr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(rows))
    tw = torch.tensor(w, requires_grad=True)
    tr = torch.tensor(rows, requires_grad=True)
    out = cache.cached_forward(tw, tr, torch.tensor(hit), torch.tensor(slot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jv))
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jgw)).max())
    np.testing.assert_array_equal(tr.grad.numpy(), np.asarray(jgr))
    assert float(tr.grad[torch.tensor(hit)].abs().sum()) == 0.0


def test_hits_give_the_cores_no_gradient():
    """Every id a hit: the TT path looks up id 0 at every position with a
    zero gradient, so the cores get none; the cache rows get all of it."""
    emb = TTEmbeddingBag(N, D, (4, 4), cache_size=K)
    freq = np.zeros(N, np.int64)
    freq[np.arange(100, 100 + K)] = 1
    emb.cache_populate(freq)
    ids = torch.tensor(np.random.default_rng(6).integers(100, 100 + K, 500))
    (emb(ids) ** 2).sum().backward()
    for c in emb.cores:
        assert float(c.grad.abs().sum()) == 0.0
    assert float(emb.cache_weight.grad.abs().sum()) > 0.0
    # nothing counted: device_freq is off
    assert int(emb.cache_freq.sum()) == K


def test_module_counts_accesses_with_device_freq():
    emb = TTEmbeddingBag(N, D, (4, 4), cache_size=K, device_freq=True)
    ids = np.random.default_rng(7).integers(0, N, 900)
    emb(torch.tensor(ids))
    emb(torch.tensor(ids), count_accesses=False)
    np.testing.assert_array_equal(emb.cache_freq.numpy(), np.bincount(ids, minlength=N))
    assert emb.cache_freq.dtype == torch.int32 and emb.cache_ids.dtype == torch.int32


def test_cache_group_optimizers_match_jax():
    """The cache rows' group on its own, 3 steps of rowwise adagrad at
    cache_lr 0.01 against the JAX make_optimizer's "cache" transform: rows
    within 1e-5 of their largest change (f32), the accumulator within
    1e-5; reset_cache_opt_state zeroes it, so the next step is a first
    step's."""
    jax_optim = importlib.import_module("falcon_ttdforgnns_tpu.train.optim")
    from falcon_ttdforgnns_torch.train import optim
    rng = np.random.default_rng(12)
    w0 = rng.normal(size=(K, D)).astype(np.float32)
    grads = [rng.normal(size=(K, D)).astype(np.float32) for _ in range(3)]
    tx = jax_optim.make_optimizer(lr=0.003, cache_optimizer="rowwise_adagrad",
                                  cache_lr=0.01, plateau=False)
    params = {"embed": {"cache_weight": jnp.asarray(w0)}}
    state = tx.init(params)
    w = torch.tensor(w0)
    ours = optim.cache_opt_init(w, lr=0.01)
    one = torch.ones(())
    for g in grads:
        upd, state = tx.update({"embed": {"cache_weight": jnp.asarray(g)}}, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        optim.cache_update(w, torch.tensor(g), ours, one)
    want = np.asarray(params["embed"]["cache_weight"])
    np.testing.assert_allclose(w.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want - w0).max())
    acc = np.asarray(state[0].inner_states["cache"].inner_state["embed"]["cache_weight"])
    np.testing.assert_allclose(ours.acc.numpy(), acc, rtol=1e-5)
    optim.reset_cache_opt_state(ours)
    fresh = optim.cache_opt_init(w, lr=0.01)
    a, b = w.clone(), w.clone()
    optim.cache_update(a, torch.tensor(grads[0]), ours, one)
    optim.cache_update(b, torch.tensor(grads[0]), fresh, one)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    return hard_synthetic_dataset(**kw), jax_hard(**kw)


def jax_step(jtr, b):
    jtr.variables, jtr.opt_state, jl, _ = jtr._step_fn(
        jtr.variables, jtr.opt_state, jnp.asarray(b.seeds),
        [jnp.asarray(l) for l in b.layers], jnp.asarray(b.labels), jax.random.PRNGKey(0))
    return float(jl)


def jax_cache_acc(jtr):
    return np.asarray(jtr.opt_state[0].inner_states["cache"].inner_state["embed"]["cache_weight"])


def check_trainers(jtr, tr):
    """Params (the cores and the tower after Adam carry Adam's ~1e-3 lr
    floor a step; see tests/test_torch_trainer.py), the cache rows (rowwise
    adagrad's normalised steps: the same floor), the id table, counts and
    ready flag (identical), the cache accumulator (1e-4 of its largest)."""
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    ours = dict(tr.model.named_parameters())
    floor = 6 * 1e-3 * LR
    for k in range(len(tr.cores)):
        np.testing.assert_allclose(ours[f"embed.tt_core_{k}"].detach().numpy(),
                                   params["embed"][f"tt_core_{k}"], rtol=1e-4, atol=floor)
    for i in range(TINY["num_layers"]):
        np.testing.assert_allclose(ours[f"convs.{i}.lin_self.weight"].detach().numpy(),
                                   params[f"conv_{i}"]["self"]["kernel"].T, rtol=1e-4,
                                   atol=floor)
    np.testing.assert_allclose(ours["embed.cache_weight"].detach().numpy(),
                               params["embed"]["cache_weight"], rtol=1e-4, atol=floor)
    meta = jax.tree.map(np.asarray, jtr.variables["ttcache"]["embed"]["meta"])
    emb = tr.model.embed
    np.testing.assert_array_equal(emb.cache_ids.numpy(), meta.ids)
    np.testing.assert_array_equal(emb.cache_freq.numpy(), meta.freq)
    assert bool(emb.cache_ready) == bool(meta.ready)
    acc = jax_cache_acc(jtr)
    np.testing.assert_allclose(tr.cache_opt.acc.numpy(), acc, rtol=1e-4,
                               atol=1e-4 * max(np.abs(acc).max(), 1e-30))


def run_cache_lifecycle(datasets, **kw):
    """3 warmup steps, the populate (JAX from the port loader's counts, as
    its own loader would count the same batches), 3 cached steps; the hit
    share of each cached batch."""
    ds, jds = datasets
    cfg = dict(TINY, cache_size=K, **kw)
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **cfg))
    tr = SageTrainer(ds, TrainConfig(**cfg), device="cpu")
    assert not tr.fused_sparse and not jtr._fused_sparse  # the cache turns it off
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    batches = iter(tr.loader)
    losses, hits = [], []
    for phase in ("warmup", "cached"):
        if phase == "cached":
            jtr.loader.freq = tr.loader.freq.copy()
            jtr.maybe_populate_cache()
            tr.maybe_populate_cache()
            check_trainers(jtr, tr)
            assert float(tr.cache_opt.acc.abs().sum()) == 0.0  # reset at populate
        for _ in range(3):
            b = next(batches)
            if phase == "cached":
                ids, _, _ = collect_level_ids(torch.tensor(b.seeds),
                                              [torch.tensor(l) for l in b.layers])
                hits.append(float(cache.lookup(tr.model.embed.cache_meta, ids)[0]
                                  .float().mean()))
            jl = jax_step(jtr, b)
            loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
            losses.append((float(loss), jl))
    return jtr, tr, losses, hits


@pytest.mark.parametrize("kw", [dict(sparse=True), dict(tt_optimizer="rowwise_adagrad")],
                         ids=["sparse-falls-back", "routed-rowwise"])
def test_cache_trainer_tracks_jax_through_populate(datasets, kw):
    jtr, tr, losses, hits = run_cache_lifecycle(datasets, **kw)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=1e-5)
    assert all(h > 0.1 for h in hits)  # K=256 of 2000 nodes serves many accesses
    check_trainers(jtr, tr)
    assert float(tr.cache_opt.acc.abs().sum()) > 0.0
    # convert carries the cache: rows, metadata and the accumulator
    fresh = SageTrainer(datasets[0], TrainConfig(**TINY, cache_size=K, **kw), device="cpu")
    load_jax_variables(fresh, jax.tree.map(np.asarray, jtr.variables),
                       cache_acc=jax_cache_acc(jtr))
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    np.testing.assert_array_equal(fresh.model.embed.cache_weight.detach().numpy(),
                                  params["embed"]["cache_weight"])
    np.testing.assert_array_equal(fresh.cache_opt.acc.numpy(), jax_cache_acc(jtr))
    check_trainers(jtr, fresh)


def test_puregpu_cache_counts_in_the_step_as_jax(datasets):
    """--mode puregpu with a cache: the step counts its ids (device_freq),
    as the JAX step does, and the populate takes those counts; steps on the
    same layers track JAX's before and after it."""
    ds, jds = datasets
    cfg = dict(TINY, cache_size=K, mode="puregpu")
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **cfg))
    tr = SageTrainer(ds, TrainConfig(**cfg), device="cpu")
    assert tr.model.embed.device_freq
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    loader = SageTrainer(ds, TrainConfig(**TINY, cache_size=K), device="cpu").loader
    batches = iter(loader)
    for step in range(4):
        if step == 2:
            jtr.maybe_populate_cache()
            tr.maybe_populate_cache()
        b = next(batches)
        jl = jax_step(jtr, b)
        loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
        assert float(loss) == pytest.approx(jl, rel=1e-5)
    np.testing.assert_array_equal(tr.model.embed.cache_freq.numpy(), loader.freq)
    assert tr.loader.freq.sum() == 0  # the trainer's own loader never ran
    check_trainers(jtr, tr)


@pytest.mark.parametrize("sparse", [False, True])
def test_grouped_steps_match_jax(datasets, sparse):
    """--emb-name eff: the JAX trainer with grouped=True (the Efficient_TT
    prefix-dedup lookup) against the port's plain lookup, which eff is an
    alias of, three steps routed or through the fused update: the same
    sums in another order, so losses within 1e-5 and cores within Adam's
    floor."""
    ds, jds = datasets
    cfg = dict(TINY, sparse=sparse)
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, grouped=True, **cfg))
    tr = SageTrainer(ds, TrainConfig(**cfg), device="cpu")
    assert tr.fused_sparse == sparse
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    for _, b in zip(range(3), tr.loader):
        jl = jax_step(jtr, b)
        loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
        assert float(loss) == pytest.approx(jl, rel=1e-5)
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    for k in range(len(tr.cores)):
        np.testing.assert_allclose(tr.cores[k].detach().numpy(),
                                   params["embed"][f"tt_core_{k}"], rtol=1e-4,
                                   atol=3 * 1e-3 * LR)


def test_fit_populates_after_the_warmup_epoch(datasets):
    """fit(): epoch 0 warms up, the populate follows it, epoch 1 hits; the
    loader's access counts and their skew (access_percentages) are JAX's
    formula's."""
    ds = datasets[0]
    tr = SageTrainer(ds, TrainConfig(**{**TINY, "epochs": 2, "eval_every": 2},
                                     cache_size=K), device="cpu")
    res = tr.fit()
    emb = tr.model.embed
    assert bool(emb.cache_ready) and int((emb.cache_ids >= 0).sum()) == K
    assert np.isfinite(res["history"][-1]["loss"])
    assert access_percentages(tr.loader.freq) == jax_metrics.access_percentages(tr.loader.freq)
    assert access_percentages(np.zeros(5)) == jax_metrics.access_percentages(np.zeros(5))
    # the cached ids are the K most counted after epoch 0 (counts kept since)
    assert int(emb.cache_freq.sum()) < int(tr.loader.freq.sum())


def test_cli_trains_the_products_presets_flags_on_cpu(tmp_path, monkeypatch, capsys):
    """final-p's --partition 128 --use-cached and final-p2's --partition -2,
    and --emb-name eff, through the CLI on a tiny graph; the reorder cache
    lands in ./reorder_cache."""
    from falcon_ttdforgnns_torch import cli
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--dataset", "hard-ogbn-arxiv", "--synthetic-scale", "0.01",
              "--num-hidden", "16", "--num-layers", "2", "--fan-out", "3,3", "--batch", "64",
              "--tt-rank", "4,4", "--epochs", "2", "--log-dir", str(tmp_path)]
    cli.main(common + ["--partition", "128", "--use-cached", "--cache-size", "256"])
    cli.main(common + ["--partition", "-2", "--sparse", "--emb-name", "eff"])
    assert capsys.readouterr().out.count('"best"') == 2
    assert len(list((tmp_path / "reorder_cache").glob("perm_*.npy"))) == 2


def test_loader_counts_only_with_a_cache(datasets):
    """The host loader counts accesses only for a cache's populate: a
    trainer without one pays no counting and reports no counts."""
    ds = datasets[0]
    plain = SageTrainer(ds, TrainConfig(**TINY), device="cpu")
    next(iter(plain.loader))
    assert plain.loader.freq is None
    cached = SageTrainer(ds, TrainConfig(**TINY, cache_size=K), device="cpu")
    b = next(iter(cached.loader))
    np.testing.assert_array_equal(cached.loader.freq,
                                  np.bincount(b.all_nodes, minlength=ds.num_nodes))

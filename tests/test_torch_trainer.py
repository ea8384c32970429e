"""The port as a whole: the port's SageTrainer against the JAX trainer.

A JAX trainer is built on a tiny hard graph (hidden 16, 2 layers, fan-out
(3, 3), batch 64, ranks (4, 4), dropout 0 — torch and jax dropout bits
differ), its variables are loaded into the port's trainer, and both step
functions take the same host-sampled batches for 3 steps: with --sparse
(each fused core update: Pallas in interpret mode against the plain
versions) and without it (each routed core optimizer), in f32 and with the
bf16 tower.  Then evaluate() on the same weights.  ``--mode puregpu``:
the step on device-sampled layers against the mixed step and the JAX step
body on the same layers, and the epoch's seeds and labels against the JAX
trainer's.  ``--mode mixed`` with ``steps_per_call`` > 1: the epoch's
groups of loader batches against JAX's, step for step.  Also: the
plateau's auto-off under bf16, the CLI on the CPU, the device rule, and
that the port never imports JAX.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401 (a fixture)

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig

from falcon_ttdforgnns_torch.convert import load_jax_variables
from falcon_ttdforgnns_torch.graph import sampler
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
    jtr = JaxTrainer(jds, JaxConfig(sparse=sparse, steps_per_call=1, **{**TINY, **kw}))
    tr = SageTrainer(ds, TrainConfig(sparse=sparse, **{**TINY, **kw}), device="cpu")
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


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("host_sampler", ["numpy", "native"])
def test_three_certified_bf16_steps_track_jax(datasets, monkeypatch, host_sampler, seed):
    """--bf16 --sparse, the certified configuration, on either host
    sampler's batches and four trainer seeds.  The port's bf16 fan-out
    mean now rounds its partial sums as JAX's does (ROADMAP C1), so what
    is left is the bf16 products of the convs, rounded in another order.
    Readings over seeds 0-7 on both samplers (tests/bf16_share_readings.py,
    CPU): the largest difference 0.031 lr, no element past 0.1 lr, losses
    within 1.34e-4 relative.  Bounds, about 3x those: every element within
    0.1 lr (so none more than 0.1 lr apart, where 5% were allowed and
    3.5-11.6% read before the fix) and losses within 5e-4."""
    if host_sampler == "numpy":  # the port's numpy path, equal to the JAX package's
        monkeypatch.setattr(sampler, "_native", None)
    jtr, tr, losses = run_both(datasets, sparse=True, bf16=True, seed=seed)
    for ours, theirs in losses:
        assert ours == pytest.approx(theirs, rel=5e-4)
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    ours = dict(tr.model.named_parameters())
    pairs = [(ours[f"embed.tt_core_{k}"], params["embed"][f"tt_core_{k}"])
             for k in range(len(tr.cores))]
    for i in range(TINY["num_layers"]):
        pairs += [(ours[f"convs.{i}.lin_self.weight"], params[f"conv_{i}"]["self"]["kernel"].T),
                  (ours[f"convs.{i}.lin_neigh.weight"], params[f"conv_{i}"]["neigh"]["kernel"].T)]
    for a, b in pairs:
        off = np.abs(a.detach().numpy() - b)
        assert off.max() <= 0.1 * LR
        assert (off > 0.1 * LR).mean() == 0.0


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


@pytest.mark.parametrize("kw", [dict(node_shard=True),
                                dict(node_shard=True, use_sample=False),
                                dict(dist=True, node_shard=True, use_sample=False),
                                dict(dist=True, node_shard=True, eval_sampled=True)],
                         ids=["sampled", "full-neighbor", "dist-full-neighbor",
                              "dist-eval-sampled"])
def test_node_shard_at_world_size_one_is_single_device(datasets, kw):
    """--node-shard without a process group of more than one rank is the
    single-device path, as JAX's device_count() > 1 decides: no mesh, and an
    epoch and evaluate() give what the same trainer without --node-shard
    and --dist gives, bit for bit (--dist --node-shard --eval-sampled
    builds and evaluates by the sampled forward)."""
    ds = dataclasses.replace(datasets[0], train_idx=datasets[0].train_idx[:128])
    trainers = [SageTrainer(ds, TrainConfig(**{**TINY, **kw, **off}), device="cpu")
                for off in ({}, dict(node_shard=False, dist=False))]
    assert all(t.node_mesh is None and t.nshard is None and t.dp is None for t in trainers)
    stats = [t.train_epoch(0) for t in trainers]
    assert stats[0]["loss"] == stats[1]["loss"]
    for a, b in zip(*(t.model.parameters() for t in trainers)):
        assert torch.equal(a, b)
    assert trainers[0].evaluate() == trainers[1].evaluate()


def test_dist_full_neighbor_without_node_shard_raises(datasets):
    """--dist --full-neighbor without --node-shard raises JAX's ValueError
    (trainer.py:321-328): full-neighbour training scales out by the node
    axis."""
    with pytest.raises(ValueError, match="scales out via --node-shard"):
        SageTrainer(datasets[0], TrainConfig(**{**TINY, "dist": True, "use_sample": False}),
                    device="cpu")


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


# ---------------------------------------------------------------- puregpu
def recording(tr, name):
    """Wrap ``tr.<name>`` so that each call's result is kept, in order."""
    kept, inner = [], getattr(tr, name)

    def call(*args):
        out = inner(*args)
        kept.append(out)
        return out

    setattr(tr, name, call)
    return kept


def some_batches(ds, n, B=TINY["batch_size"]):
    """n (seeds, labels) int32 tensors from a seeded order of the train ids."""
    order = np.random.default_rng(5).permutation(ds.train_idx)
    return [(torch.tensor(order[i * B:(i + 1) * B].astype(np.int32)),
             torch.tensor(ds.labels[order[i * B:(i + 1) * B]].astype(np.int32)))
            for i in range(n)]


@pytest.mark.parametrize("sampler", ["csr", "table"])
def test_puregpu_step_is_the_mixed_step_on_its_layers(datasets, sampler):
    """A puregpu step (sample on the device, then the step body) equals a
    mixed step fed the layers it sampled, bit for bit on the CPU, dropout
    on: the sampler's generator is not the dropout generator's."""
    ds = datasets[0]
    kw = dict(TINY, dropout=0.5, sparse=True, sampler=sampler, table_width=8)
    pure = SageTrainer(ds, TrainConfig(mode="puregpu", **kw), device="cpu")
    mixed = SageTrainer(ds, TrainConfig(**kw), device="cpu")
    layers = recording(pure, "sample_layers")
    for i, (seeds, labels) in enumerate(some_batches(ds, 3)):
        lp, ap = pure.device_train_step(seeds, labels)
        lm, am = mixed.train_step(seeds, [l.numpy() for l in layers[i]], labels.numpy())
        assert torch.equal(lp, lm) and torch.equal(ap, am)
    for a, b in zip(pure.model.parameters(), mixed.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(pure.tt_opt.m + pure.tt_opt.v, mixed.tt_opt.m + mixed.tt_opt.v):
        assert torch.equal(a, b)


def test_three_puregpu_steps_match_jax(datasets):
    """Three --mode puregpu --sparse steps against the JAX step body
    (``_step_fn``) fed the layers the port sampled, at the tolerances of
    test_three_sparse_steps_match_jax."""
    ds, jds = datasets
    jtr = JaxTrainer(jds, JaxConfig(sparse=True, steps_per_call=1, **TINY))
    tr = SageTrainer(ds, TrainConfig(mode="puregpu", sparse=True, **TINY), device="cpu")
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    layers = recording(tr, "sample_layers")
    for i, (seeds, labels) in enumerate(some_batches(ds, 3)):
        loss, _ = tr.device_train_step(seeds, labels)
        jtr.variables, jtr.opt_state, jl, _ = jtr._step_fn(
            jtr.variables, jtr.opt_state, jnp.asarray(seeds.numpy()),
            [jnp.asarray(l.numpy()) for l in layers[i]], jnp.asarray(labels.numpy()),
            jax.random.PRNGKey(0))
        assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    check_params(jtr, tr)
    assert int(tr.tt_opt.count) == 3


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_puregpu_epoch_seeds_and_labels_match_jax(datasets, steps_per_call):
    """The puregpu epoch's seeds and labels, step for step, are the JAX
    trainer's (_train_epoch_device, recorded at its _device_multi_fn, which
    is not run) on 300 train ids: ragged at both group sizes, the tail
    wrapped around the epoch's order; and its step count."""
    ds, jds = datasets
    ds = dataclasses.replace(ds, train_idx=ds.train_idx[:300])
    jds = dataclasses.replace(jds, train_idx=jds.train_idx[:300])
    kw = dict(TINY, mode="puregpu", steps_per_call=steps_per_call, sparse=True)
    jtr = JaxTrainer(jds, JaxConfig(**kw))
    packs = []

    def record(variables, opt_state, packed, *rest):
        packs.append(np.asarray(packed))
        return variables, opt_state, jnp.float32(0), jnp.float32(0)

    jtr._device_multi_fn = record
    tr = SageTrainer(ds, TrainConfig(**kw), device="cpu")
    seen = []
    inner = tr.device_train_step

    def keep(seeds, labels):
        seen.append((seeds.numpy().copy(), labels.numpy().copy()))
        return inner(seeds, labels)

    tr.device_train_step = keep
    epoch = 1
    jtr._train_epoch_device(epoch)
    stats = tr.train_epoch(epoch)
    want = [p[i] for p in packs for i in range(steps_per_call)]
    assert len(seen) == len(want) == tr.step
    assert tr.step == -(-300 // (64 * steps_per_call)) * steps_per_call
    for (seeds, labels), w in zip(seen, want):
        np.testing.assert_array_equal(seeds, w[:, 0])
        np.testing.assert_array_equal(labels, w[:, 1])
    assert np.isfinite(stats["loss"])


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("steps_per_call", [1, 2, 8])
def test_mixed_epoch_groups_match_jax(jax_native, datasets, steps_per_call, sparse):
    """ROADMAP C4: the mixed epoch's batches (seeds, layers, labels), step
    for step, are the JAX trainer's, recorded at its _multi_fn (at S = 1 its
    _step_fn), which is not run, on 300 train ids at batch 64: 4 loader
    batches, so that at S = 8 the one group is ragged and cycles through the
    epoch's first batches; the step count is ceil(4 / S) * S."""
    ds, jds = datasets
    ds = dataclasses.replace(ds, train_idx=ds.train_idx[:300])
    jds = dataclasses.replace(jds, train_idx=jds.train_idx[:300])
    kw = dict(TINY, steps_per_call=steps_per_call, sparse=sparse)
    jtr = JaxTrainer(jds, JaxConfig(**kw))
    want = []

    def record_step(variables, opt_state, seeds, layers, labels, rng):
        want.append((np.asarray(seeds), [np.asarray(l) for l in layers], np.asarray(labels)))
        return variables, opt_state, jnp.float32(0), jnp.float32(0)

    def record_group(variables, opt_state, packed, rng):
        widths = np.cumsum([0] + jtr._layer_widths()) + 2
        for row in np.asarray(packed):
            want.append((row[:, 0], [row[:, a:b] for a, b in zip(widths[:-1], widths[1:])],
                         row[:, 1]))
        return variables, opt_state, jnp.float32(0), jnp.float32(0)

    if steps_per_call == 1:
        jtr._step_fn = record_step
    else:
        jtr._multi_fn = record_group
    jtr.train_epoch(0)
    tr = SageTrainer(ds, TrainConfig(**kw), device="cpu")
    args = []
    inner = tr.train_step

    def keep(seeds, layers, labels):
        args.append((seeds, layers, labels))
        return inner(seeds, layers, labels)

    tr.train_step = keep
    stats = tr.train_epoch(0)
    assert len(args) == len(want) == tr.step == -(-4 // steps_per_call) * steps_per_call
    for (seeds, layers, labels), (ws, wl, wy) in zip(args, want):
        np.testing.assert_array_equal(seeds, ws)
        np.testing.assert_array_equal(labels, wy)
        for a, b in zip(layers, wl, strict=True):
            np.testing.assert_array_equal(a, b)
    assert np.isfinite(stats["loss"])


@pytest.mark.parametrize("sampler", ["csr", "table"])
def test_puregpu_epoch_trains(datasets, sampler):
    """An epoch of --mode puregpu --sparse --bf16 trains under each
    sampler: finite loss, the cores and dense params move, the graph (and
    the table, of the JAX package's shape and bits) placed once."""
    ds = dataclasses.replace(datasets[0], train_idx=datasets[0].train_idx[:256])
    cfg = TrainConfig(mode="puregpu", sparse=True, bf16=True, sampler=sampler,
                      table_width=16, steps_per_call=2, **TINY)
    tr = SageTrainer(ds, cfg, device="cpu")
    assert tr._indptr_dev.dtype == tr._indices_dev.dtype == torch.int32
    if sampler == "table":
        assert tuple(tr._table_dev.shape) == (ds.num_nodes, 16)
        from falcon_ttdforgnns_tpu.graph.device_sampler import build_neighbor_table
        np.testing.assert_array_equal(tr._table_dev.numpy(), build_neighbor_table(
            ds.graph.indptr, ds.graph.indices, 16, cfg.seed))
    else:
        assert tr._table_dev is None
    before = [p.detach().clone() for p in tr.model.parameters()]
    stats = tr.train_epoch(0)
    assert np.isfinite(stats["loss"]) and tr.step == 4
    assert all(not torch.equal(a, b) for a, b in zip(before, tr.model.parameters()))


def test_puregpu_graph_guard_raises(datasets):
    """A graph of 2^31 edges or more cannot be placed as int32: it raises
    NotImplementedError before anything is placed (a stub graph that only
    claims the edge count)."""
    class Huge:
        num_nodes, num_edges = 2000, 2**31

    ds = dataclasses.replace(datasets[0], graph=Huge())
    with pytest.raises(NotImplementedError, match="2\\^31"):
        SageTrainer(ds, TrainConfig(mode="puregpu", **TINY), device="cpu")


def test_rbg_rng_impl_is_accepted_and_inert(datasets, capsys):
    """--rng-impl rbg names the TPU's generator: accepted, one line says
    it is inert, and the samples are the threefry run's."""
    ds = dataclasses.replace(datasets[0], train_idx=datasets[0].train_idx[:64])
    runs = []
    for impl in ("threefry", "rbg"):
        tr = SageTrainer(ds, TrainConfig(mode="puregpu", rng_impl=impl, steps_per_call=1,
                                         **TINY), device="cpu")
        runs.append(recording(tr, "sample_layers"))
        tr.train_epoch(0)
    assert len(runs[0]) == len(runs[1]) == 1
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert capsys.readouterr().err.count("--rng-impl rbg") == 1


def test_cli_puregpu_runs_on_cpu(capsys, tmp_path):
    from falcon_ttdforgnns_torch import cli
    cli.main(["--device", "cpu", "--dataset", "hard-ogbn-arxiv", "--synthetic-scale",
              "0.004", "--num-hidden", "16", "--num-layers", "2", "--fan-out", "3,3",
              "--batch", "64", "--tt-rank", "4,4", "--epochs", "1", "--log-dir",
              str(tmp_path), "--mode", "puregpu", "--sparse", "--bf16", "--sampler", "table",
              "--table-width", "8", "--steps-per-call", "4"])
    assert '"best"' in capsys.readouterr().out

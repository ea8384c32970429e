"""--dist, --multihost and the dry run of the port (ROADMAP A8.1, A8.2,
A8.4) on the CPU.

The port's ranks are gloo ranks spawned by ``torch.multiprocessing`` from
the package (``parallel/launch.py``: a spawned rank imports the module of
its function, and this one imports JAX), two a group, meeting at a file
store under ``tmp_path``.  JAX's side runs on the 8 virtual CPU devices of
``tests/conftest.py``.  Dropout is 0 on both sides: no rank's dropout bits
are JAX's.  The identity the port is held to is JAX's: the data-parallel
step is the single-device step on the whole batch (``trainer.py:815-818``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401 (a fixture)

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph import sample_block as jax_sample_block
from falcon_ttdforgnns_tpu.graph import synthetic_dataset as jax_synthetic
from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.models import SAGE as JaxSAGE
from falcon_ttdforgnns_tpu.parallel import (make_dp_train_step, make_mesh, replicate,
                                            shard_batch)
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig
from falcon_ttdforgnns_tpu.train.optim import make_optimizer

from falcon_ttdforgnns_torch import graft_entry
from falcon_ttdforgnns_torch.convert import load_jax_variables, params_from_jax
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset, synthetic_dataset
from falcon_ttdforgnns_torch.parallel import (DataParallel, backend_for, init_multihost,
                                              scaling_efficiency, world_size)
from falcon_ttdforgnns_torch.parallel.launch import spawn, train_rank
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

LR = 0.003
TINY = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2,
            tt_ranks=(4, 4), dropout=0.0, lr=LR, seed=0)


def run_ranks(tmp_path, jobs, n=2):
    """``jobs`` on each of n gloo ranks (launch.train_rank); their results."""
    spawn(train_rank, n, "cpu", str(tmp_path / "store"), jobs, str(tmp_path))
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(n)]


def same_replicas(results):
    """Every rank's state is rank 0's, bit for bit."""
    for other in results[1:]:
        for a, b in zip(results[0], other):
            if "state" in a:
                for k in a["state"]:
                    assert torch.equal(a["state"][k], b["state"][k]), k
                assert a["losses"] == b["losses"] and a["plateau_best"] == b["plateau_best"]
                assert [(s["loss"], s["train_acc"]) for s in a["stats"]] == [
                    (s["loss"], s["train_acc"]) for s in b["stats"]]


def close(ours, theirs, rtol, atol):
    for k, want in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), want.numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def same_optimizer_state(got, one):
    """The dense params' Adam moments and the plateau's best loss of a
    rank against one process's trainer, at f32 tolerance: Adam's step is
    blind to a gradient's scale, its moments are not (a factor 1/W applied
    twice or not at all), and the plateau must have seen the global loss."""
    for ours, theirs in ((got["adam_m"], one.opt_state.m), (got["adam_v"], one.opt_state.v)):
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))
    assert got["plateau_best"] == pytest.approx(float(one.plateau.best_value), rel=1e-5)


@pytest.fixture(scope="module")
def hard():
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    ds, jds = hard_synthetic_dataset(**kw), jax_hard(**kw)
    return (dataclasses.replace(ds, train_idx=ds.train_idx[:256]),
            dataclasses.replace(jds, train_idx=jds.train_idx[:256]))


def test_dp_step_matches_jax_dp_and_single_device(jax_native, tmp_path):
    """One --dist step over 2 gloo ranks against JAX's make_dp_train_step
    on the 8-device mesh and JAX's single-device step, at the shapes of
    tests/test_parallel.py (800 nodes, SAGE 2x16, ranks 4,4, batch 32 at
    fan-out 2,3, Adam at lr 0.01, no plateau): the loss at 1e-5 relative,
    the parameters at JAX's own DP-against-one-device tolerance (5e-4 /
    1e-5).  The ranks hold the same parameters, bit for bit, and reduced
    every gradient, the loss and the accuracy in one all-reduce."""
    jds = jax_synthetic(num_nodes=800, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    model = JaxSAGE(num_nodes=jds.num_nodes, in_dim=16, hidden_dim=16, num_classes=4,
                    num_layers=2, use_tt=True, tt_ranks=(4, 4), weight_dist="normal",
                    dropout=0.0)
    b = jax_sample_block(jds.graph, np.arange(32), (2, 3), np.random.default_rng(0))
    seeds, labels = jnp.asarray(b.seeds), jnp.asarray(jds.labels[b.seeds].astype(np.int32))
    layers = tuple(jnp.asarray(l) for l in b.layers)
    key = jax.random.PRNGKey(0)
    variables = model.init({"params": key, "dropout": key}, seeds, layers)
    tx = make_optimizer(lr=0.01, plateau=False)

    def step(vs, os_, s, ls, y, k):
        def loss_fn(p):
            out = model.apply({"params": p}, s, ls, train=True, rngs={"dropout": k})
            return optax.softmax_cross_entropy_with_integer_labels(out, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(vs["params"])
        ups, _ = tx.update(grads, os_, vs["params"], value=loss)
        return optax.apply_updates(vs["params"], ups), loss

    host_vars = jax.tree.map(np.asarray, variables)
    single_params, single_loss = jax.jit(step)(variables, tx.init(variables["params"]),
                                               seeds, layers, labels, key)
    mesh = make_mesh(n_data=8)
    s, y = shard_batch(mesh, seeds, labels)
    dp_vars, _, dp_loss, _ = make_dp_train_step(model, tx, mesh)(
        replicate(mesh, variables), replicate(mesh, tx.init(variables["params"])), s,
        tuple(shard_batch(mesh, l) for l in layers), y, replicate(mesh, key))

    ds = synthetic_dataset(num_nodes=800, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    cfg = TrainConfig(batch_size=32, fanouts=(2, 3), hidden_dim=16, num_layers=2,
                      tt_ranks=(4, 4), weight_dist="normal", dropout=0.0, lr=0.01,
                      plateau_patience=0, dist=True)
    batch = (np.asarray(b.seeds), [np.asarray(l) for l in b.layers], np.asarray(labels))
    results = run_ranks(tmp_path, [dict(dataset=ds, cfg=cfg, variables=host_vars,
                                        batches=[batch])])
    same_replicas(results)
    got = results[0][0]
    assert got["data_parallel"] and not got["fused"]
    n_params = sum(p.numel() for p in SageTrainer(ds, dataclasses.replace(cfg, dist=False),
                                                  device="cpu").model.parameters())
    assert got["reduced_bytes"] == 4 * (n_params + 2)
    for want in (float(dp_loss), float(single_loss)):
        assert got["losses"][0] == pytest.approx(want, rel=1e-5)
    for want in (dp_vars["params"], single_params):
        close(got["state"], params_from_jax(jax.tree.map(np.asarray, want)), 5e-4, 1e-5)


def test_mixed_dist_epoch_matches_jax_dist_trainer(jax_native, hard, tmp_path):
    """Mixed --dist --sparse with steps_per_call 2 over 2 gloo ranks against
    JAX's SageTrainer(dist=True) on the 8-device mesh (make_dp_multi_step):
    256 train ids at batch 64 make 2 groups of 2 steps.  The fused update is
    off, as in JAX (no tt_opt state), so the cores take routed Adam through
    TTLookup's backward; the epoch's loss at 1e-5 relative and the
    parameters at the tolerance of test_torch_trainer.py's three-step
    comparisons (1e-4 relative, 3e-3 lr)."""
    ds, jds = hard
    kw = dict(TINY, dist=True, sparse=True, steps_per_call=2)
    jtr = JaxTrainer(jds, JaxConfig(**kw))
    assert jtr.mesh is not None and jtr._multi_fn is not None and "tt_opt" not in jtr.variables
    host_vars = jax.tree.map(np.asarray, jtr.variables)
    jstats = jtr.train_epoch(0)
    results = run_ranks(tmp_path, [dict(dataset=ds, cfg=TrainConfig(**kw),
                                        variables=host_vars, epochs=1)])
    same_replicas(results)
    got = results[0][0]
    assert got["data_parallel"] and not got["fused"] and got["tt_m"] is None
    assert got["step"] == jtr.step == 4
    assert got["stats"][0]["loss"] == pytest.approx(jstats["loss"], rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jtr.variables["params"]))
    close(got["state"], want, 1e-4, 3 * 1e-3 * LR)
    # the routed Adam of one process (mixed --sparse without --dist would fuse)
    one = SageTrainer(ds, TrainConfig(**dict(kw, dist=False, sparse=False)), device="cpu")
    load_jax_variables(one, host_vars)
    one.train_epoch(0)
    same_optimizer_state(got, one)


def test_puregpu_dist_epoch_matches_one_process(hard, tmp_path):
    """--mode puregpu --dist --sparse over 2 gloo ranks against the same
    epoch in one process, for fused Adam and fused rowwise adagrad: every
    rank samples the whole batch from the shared stream and keeps its rows,
    so the batches are the single process's; the cores' gradients from
    tt_grads are all-reduced before tt_adam_apply / tt_adagrad_apply.  The
    loss within 1e-5, the parameters and the optimizer state at f32
    tolerance (1e-5 relative; an absolute 1e-3 lr on the parameters, the
    reordering floor of Adam's normalised step).  On the same ranks: a batch
    that does not divide by the world size, and --num-chips other than the
    world size, raise ValueError."""
    ds, _ = hard
    cfgs = {opt: TrainConfig(**dict(TINY, mode="puregpu", sparse=True, steps_per_call=2,
                                    dist=True, tt_optimizer=opt))
            for opt in ("adam", "rowwise_adagrad")}
    jobs = [dict(dataset=ds, cfg=c, epochs=1) for c in cfgs.values()]
    jobs += [dict(dataset=ds, cfg=dataclasses.replace(cfgs["adam"], batch_size=63),
                  raises=True),
             dict(dataset=ds, cfg=dataclasses.replace(cfgs["adam"], num_chips=4),
                  raises=True)]
    results = run_ranks(tmp_path, jobs)
    same_replicas(results)
    for (opt, cfg), got in zip(cfgs.items(), results[0]):
        one = SageTrainer(ds, dataclasses.replace(cfg, dist=False), device="cpu")
        stats = one.train_epoch(0)
        assert got["data_parallel"] and got["fused"] and got["step"] == one.step == 4
        assert got["stats"][0]["loss"] == pytest.approx(stats["loss"], rel=1e-5)
        close(got["state"], one.model.state_dict(), 1e-5, 1e-3 * LR)
        same_optimizer_state(got, one)
        if opt == "adam":
            assert got["tt_t"] == int(one.tt_opt.count) == 4
            for ours, theirs in ((got["tt_m"], one.tt_opt.m), (got["tt_v"], one.tt_opt.v)):
                for a, b in zip(ours, theirs, strict=True):
                    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                               atol=1e-5 * float(b.abs().max()))
        else:
            for a, b in zip(got["tt_acc"], one.tt_acc, strict=True):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert "must divide by the data axis (2)" in results[0][2]["raised"]
    assert "--nproc-per-node 4" in results[0][3]["raised"]


def test_dist_checks_and_world_size_one(hard, tmp_path, monkeypatch):
    """--dist with --full-neighbor raises ValueError (JAX trainer.py:321-328);
    --num-chips other than the world size raises; --multihost in one
    process sets nothing up, and with COORDINATOR_ADDRESS but not
    NUM_PROCESSES/PROCESS_ID raises JAX's ValueError; the backend follows
    the device asked for, and a gloo group on a CUDA device raises.  At
    world size 1, with no group and with a one-rank gloo group, --dist
    trains exactly as without it: the single-device path, as JAX's
    device_count() > 1 decides."""
    ds, _ = hard
    with pytest.raises(ValueError, match="node-shard"):
        SageTrainer(ds, TrainConfig(**TINY, dist=True, use_sample=False), device="cpu")
    with pytest.raises(ValueError, match="--nproc-per-node 2"):
        SageTrainer(ds, TrainConfig(**TINY, dist=True, num_chips=2), device="cpu")
    for var in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost("cpu") == 1 and not dist.is_initialized()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES/PROCESS_ID"):
        init_multihost("cpu")
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    assert (backend_for("cuda"), backend_for("cpu")) == ("nccl", "gloo")

    def epoch(**kw):
        tr = SageTrainer(ds, TrainConfig(**TINY, sparse=True, steps_per_call=2, **kw),
                         device="cpu")
        assert tr.dp is None and tr.fused_sparse
        return tr.train_epoch(0), tr

    (s0, base), (s1, flat) = epoch(), epoch(dist=True)
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        assert world_size() == 1
        s2, grouped = epoch(dist=True, num_chips=1)
        with pytest.raises(ValueError, match="nccl process group, got gloo"):
            DataParallel("cuda", dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    for stats, tr in ((s1, flat), (s2, grouped)):
        assert stats["loss"] == s0["loss"] and tr.step == base.step == 4
        for a, b in zip(tr.model.parameters(), base.model.parameters()):
            assert torch.equal(a, b)
    assert scaling_efficiency({1: 100.0, 8: 640.0})[8] == pytest.approx(0.8)


def test_dryrun_multichip_and_entry_on_cpu(capsys):
    """graft_entry: the flagship forward at the JAX entry's small shapes,
    and dryrun_multichip(2) on gloo ranks (a --dist step, a mixed epoch in
    groups of 2, a puregpu --sparse epoch, the replicas equal; then
    --node-shard: the dense-bucket and ragged rings within 1e-3 of the
    plain sum, a node-sharded full-neighbour epoch)."""
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (32, 8) and torch.isfinite(out).all()
    res = graft_entry.dryrun_multichip(2, device="cpu")
    assert all(np.isfinite(v) for v in res.values())
    out = capsys.readouterr().out
    assert "dryrun_multichip(2) on cpu" in out and "node-sharded full-neighbor" in out
    assert max(res["ring_err"], res["ragged_err"]) <= 1e-3


def test_cli_dist_under_torchrun_on_cpu(tmp_path):
    """The CLI under torch.distributed.run, 2 ranks on the CPU, --dist
    --multihost --mode puregpu --sparse: rc 0, rank 0 alone logs (the gloo
    group of world size 2 named) and prints the result, and its checkpoint
    is written once."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "falcon_ttdforgnns_torch.cli", "--device", "cpu", "--dist",
           "--multihost", "--dataset", "hard-ogbn-arxiv", "--synthetic-scale", "0.004",
           "--num-hidden", "16", "--num-layers", "2", "--fan-out", "3,3", "--batch", "64",
           "--tt-rank", "4,4", "--epochs", "1", "--mode", "puregpu", "--sparse",
           "--steps-per-call", "2", "--save-model", "--ckpt-dir", str(tmp_path / "ck"),
           "--log-dir", str(tmp_path / "logs")]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.count('"best"') == 1
    assert p.stderr.count("process group backend gloo, world size 2") == 1
    assert len(os.listdir(tmp_path / "ck")) == 1

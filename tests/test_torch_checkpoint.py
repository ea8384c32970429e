"""Checkpointing of the port (``train/checkpoint.py``, ``SageTrainer.save``/
``restore``, ``cli --save-model --save-pred``), mirroring the JAX package's
tests (tests/test_aux.py: the round trip, the latest checkpoint, save /
restore / continue, the fused optimizers' state), plus: the cache's state
after populate round-trips; resuming at an epoch boundary continues bit for
bit as the uninterrupted run; the JAX trainer's variables, carried into
the port, survive a save and restore.
"""

import jax
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401 (a fixture)

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph import synthetic_dataset as jax_synthetic
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig

from falcon_ttdforgnns_torch.convert import load_jax_variables
from falcon_ttdforgnns_torch.graph import synthetic_dataset
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
from falcon_ttdforgnns_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                                      save_checkpoint)

SMALL = dict(batch_size=64, fanouts=(3, 3), epochs=1, hidden_dim=16, num_layers=2,
             use_tt=True, tt_ranks=(4, 4), weight_dist="normal", eval_every=10**9,
             log_every=10**9, seed=5)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=400, avg_degree=5, num_classes=4, feat_dim=16, seed=3)


def trainer(ds, **kw):
    return SageTrainer(ds, TrainConfig(**{**SMALL, **kw}), device="cpu")


def test_roundtrip(tmp_path):
    variables = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                            "b": torch.ones(3)}}
    opt_state = {"mu": torch.zeros(2, 3)}
    path = save_checkpoint(str(tmp_path), 7, variables, opt_state, {"best": 0.5})
    assert latest_checkpoint(str(tmp_path)) == path
    restored = restore_checkpoint(path, {"variables": variables, "opt_state": opt_state})
    assert torch.equal(restored["variables"]["params"]["w"], variables["params"]["w"])
    assert torch.equal(restored["opt_state"]["mu"], opt_state["mu"])
    assert restored["extra"] == {"best": 0.5}
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"variables": {"other": 1}})


def test_multiple_steps_latest_skips_tmp(tmp_path):
    v = {"x": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 1, v, {})
    p2 = save_checkpoint(str(tmp_path), 10, v, {})
    (tmp_path / "step_99.pt.tmp").write_bytes(b"an interrupted save")
    assert latest_checkpoint(str(tmp_path)) == p2
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_save_restore_continue(ds, tmp_path):
    t1 = trainer(ds)
    t1.train_epoch(0)
    path = t1.save(str(tmp_path))
    logits1 = t1.infer_full()
    t2 = trainer(ds)  # fresh init (another state)
    t2.restore(path)
    assert t2.step == t1.step
    assert torch.equal(t2.infer_full(), logits1)
    stats = t2.train_epoch(1)
    assert np.isfinite(stats["loss"])
    t3 = trainer(ds)
    t3.restore(ckpt_dir=str(tmp_path))  # the latest of the directory
    assert t3.step == t1.step
    with pytest.raises(FileNotFoundError):
        trainer(ds).restore(ckpt_dir=str(tmp_path / "empty"))


@pytest.mark.parametrize("opt", ["adagrad", "rowwise_adagrad"])
def test_fused_adagrad_state_roundtrips(ds, tmp_path, opt):
    """The fused adagrad accumulators survive save/restore (a reset one
    would restart the adagrad schedule)."""
    t1 = trainer(ds, sparse=True, tt_optimizer=opt)
    t1.train_epoch(0)
    assert t1.fused_sparse and any(float(a.max()) > 0 for a in t1.tt_acc)
    path = t1.save(str(tmp_path))
    t2 = trainer(ds, sparse=True, tt_optimizer=opt)
    t2.restore(path)
    for a, b in zip(t2.tt_acc, t1.tt_acc):
        assert torch.equal(a, b)
    assert np.isfinite(t2.train_epoch(1)["loss"])


def test_fused_adam_state_roundtrips(ds, tmp_path):
    """The fused-Adam moments and step count survive save/restore (a reset
    t would replay the bias-correction warmup, a reset v the lr ramp)."""
    t1 = trainer(ds, sparse=True)
    t1.train_epoch(0)
    assert int(t1.tt_opt.count) > 0
    path = t1.save(str(tmp_path))
    t2 = trainer(ds, sparse=True)
    t2.restore(path)
    assert int(t2.tt_opt.count) == int(t1.tt_opt.count)
    for k in range(len(t1.cores)):
        assert torch.equal(t2.tt_opt.m[k], t1.tt_opt.m[k])
        assert torch.equal(t2.tt_opt.v[k], t1.tt_opt.v[k])
    for a, b in zip(t2.opt_state.m + t2.opt_state.v, t1.opt_state.m + t1.opt_state.v):
        assert torch.equal(a, b)
    assert np.isfinite(t2.train_epoch(1)["loss"])


def test_cache_state_after_populate_roundtrips(ds, tmp_path):
    """After the warmup epoch and the populate: the cache's rows, its id
    table, counts and ready flag, the cache group's accumulator (nonzero
    after a cached epoch) and the loader's counts survive save/restore."""
    t1 = trainer(ds, cache_size=32)
    t1.train_epoch(0)
    t1.maybe_populate_cache()
    t1.train_epoch(1)
    assert bool(t1.model.embed.cache_ready) and float(t1.cache_opt.acc.max()) > 0
    path = t1.save(str(tmp_path))
    t2 = trainer(ds, cache_size=32)
    t2.restore(path)
    for name, buf in t1.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[name], buf), name
    assert torch.equal(t2.cache_opt.acc, t1.cache_opt.acc)
    assert np.array_equal(t2.loader.freq, t1.loader.freq)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mode="puregpu", sparse=True, bf16=True, steps_per_call=2),
    dict(sparse=True, bf16=True, bf16_sr=True, num_workers=2),
    dict(cache_size=32),
    dict(use_tt=False, access_counts=True),
], ids=["routed", "puregpu-fused-bf16", "sr-two-workers", "cache", "dense-counts"])
def test_resume_at_an_epoch_boundary_is_bit_identical(ds, tmp_path, kw):
    """Epochs 0 and 1 uninterrupted, against epoch 0, save, a fresh trainer
    restored, epoch 1: every parameter, buffer and optimizer tensor equal
    bit for bit.  What carries across epochs rides in the checkpoint: the
    SR store's generator, the host loader's generator (its spawn count
    under two workers) and counts, the cache after its populate."""
    whole = trainer(ds, **kw)
    first = trainer(ds, **kw)
    for t in (whole, first):
        t.train_epoch(0)
        t.maybe_populate_cache()
    path = first.save(str(tmp_path))
    whole.train_epoch(1)
    resumed = trainer(ds, **kw)
    resumed.restore(path)
    resumed.train_epoch(1)
    assert resumed.step == whole.step
    for name, t in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], t), name
    for a, b in zip(resumed.opt_state.m + resumed.opt_state.v,
                    whole.opt_state.m + whole.opt_state.v):
        assert torch.equal(a, b)


def test_jax_variables_survive_the_port_checkpoint(jax_native, tmp_path):
    """The JAX trainer's --sparse variables (params, fused-Adam moments and
    t after an epoch), carried into the port by load_jax_variables, come
    back unchanged through the port's save and restore."""
    kw = dict(num_nodes=400, avg_degree=5, num_classes=4, feat_dim=16, seed=3)
    jtr = JaxTrainer(jax_synthetic(**kw), JaxConfig(sparse=True, steps_per_call=1, **SMALL))
    jtr.train_epoch(0)
    variables = jax.tree.map(np.asarray, jtr.variables)
    t1 = SageTrainer(synthetic_dataset(**kw), TrainConfig(sparse=True, **SMALL), device="cpu")
    load_jax_variables(t1, variables)
    path = t1.save(str(tmp_path))
    t2 = SageTrainer(synthetic_dataset(**kw), TrainConfig(sparse=True, **SMALL), device="cpu")
    t2.restore(path)
    for k in range(len(t2.cores)):
        np.testing.assert_array_equal(t2.cores[k].detach().numpy(),
                                      variables["params"]["embed"][f"tt_core_{k}"])
        np.testing.assert_array_equal(t2.tt_opt.m[k].numpy(), variables["tt_opt"][f"m_{k}"])
        np.testing.assert_array_equal(t2.tt_opt.v[k].numpy(), variables["tt_opt"][f"v_{k}"])
    assert int(t2.tt_opt.count) == int(variables["tt_opt"]["t"])


def test_cli_save_model_and_pred(tmp_path):
    from falcon_ttdforgnns_torch.cli import main
    main(["--device", "cpu", "--dataset", "tiny-test", "--synthetic-scale", "1.0",
          "--batch", "32", "--fan-out", "3,3", "--num-hidden", "16", "--num-layers", "2",
          "--tt-rank", "4,4", "--init", "normal", "--epochs", "1", "--save-model",
          "--save-pred", "--log-dir", str(tmp_path), "--ckpt-dir", str(tmp_path)])
    pred = np.load(tmp_path / "pred_sage_tiny-test.npz")
    assert pred["logits"].ndim == 2 and pred["pred"].shape == pred["logits"].shape[:1]
    assert np.array_equal(pred["pred"], pred["logits"].argmax(-1))
    path = latest_checkpoint(str(tmp_path))
    state = restore_checkpoint(path)
    assert set(state["extra"]["best"]) >= {"val_acc", "test_acc"}
    assert "embed.tt_core_0" in state["variables"]["model"]

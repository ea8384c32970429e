"""``--full-neighbor`` SAGE training of the port against the JAX trainer on
the CPU: each step propagates over every edge (the lookup over all N ids,
one SpMM mean a layer), takes the loss on the batch's seeds and updates as
the routed body does.  The JAX trainer's variables are loaded into the
port's; both take the same seeds.  Tolerances (f32, dropout 0): losses
within 1e-5 relative; parameters within 1e-4 relative plus 3e-3 lr (Adam's
normalised step on a near-cancelled gradient element, as in
tests/test_torch_trainer.py).  Also: the tiny-trainset epoch
(tests/test_flags.py), --sparse routing the cores through Adam as JAX
does, and the bf16 flags scoped to the sampled trainers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph import synthetic_dataset as jax_synthetic
from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig

from falcon_ttdforgnns_torch.convert import load_jax_variables
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset, synthetic_dataset
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

LR = 0.003
TINY = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2, tt_ranks=(4, 4),
            dropout=0.0, lr=LR, seed=0, use_sample=False, log_every=10**9)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    return hard_synthetic_dataset(**kw), jax_hard(**kw)


def both(datasets, **kw):
    ds, jds = datasets
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **{**TINY, **kw}))
    tr = SageTrainer(ds, TrainConfig(**{**TINY, **kw}), device="cpu")
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    return jtr, tr


def check_params(jtr, tr):
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    ours = dict(tr.model.named_parameters())
    pairs = [(f"embed.tt_core_{k}", params["embed"][f"tt_core_{k}"]) for k in range(3)]
    for i in range(2):
        pairs += [(f"convs.{i}.lin_self.weight", params[f"conv_{i}"]["self"]["kernel"].T),
                  (f"convs.{i}.lin_self.bias", params[f"conv_{i}"]["self"]["bias"]),
                  (f"convs.{i}.lin_neigh.weight", params[f"conv_{i}"]["neigh"]["kernel"].T)]
    for name, want in pairs:
        np.testing.assert_allclose(ours[name].detach().numpy(), want, rtol=1e-4,
                                   atol=3 * 1e-3 * LR, err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(sparse=True), dict(tt_optimizer="adagrad")],
                         ids=["adam", "sparse", "adagrad"])
def test_three_full_neighbor_steps_match_jax(datasets, kw):
    """JAX's _full_step_fn and the port's full_neighbor_step on the same
    seeds.  Under --sparse neither side fuses the core update (it needs the
    sampled ids): the cores take routed Adam, and no fused state exists."""
    jtr, tr = both(datasets, **kw)
    assert not tr.fused_sparse and tr.tt_opt is None and "tt_opt" not in jtr.variables
    ds = datasets[0]
    src, dst = ds.graph.to_coo()
    order = np.random.default_rng(0).permutation(ds.train_idx)
    for b in range(3):
        pick = order[b * 64:(b + 1) * 64]
        jtr.variables, jtr.opt_state, jl, _ = jtr._full_step_fn(
            jtr.variables, jtr.opt_state, jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(ds.graph.degrees.astype(np.float32)), jnp.asarray(pick.astype(np.int32)),
            jnp.asarray(ds.labels[pick].astype(np.int32)), jax.random.PRNGKey(0))
        loss, acc = tr.full_neighbor_step(torch.tensor(pick.astype(np.int64)))
        assert float(loss) == pytest.approx(float(jl), rel=1e-5)
        assert 0.0 <= float(acc) <= 1.0
    check_params(jtr, tr)


def test_full_neighbor_epoch_matches_jax(datasets):
    """train_epoch: JAX's order (default_rng(seed + 31 * epoch)), floor(n /
    B) batches; with dropout 0 the epoch's mean loss and the parameters
    after it agree."""
    jtr, tr = both(datasets, batch_size=256)
    want, got = jtr.train_epoch(0), tr.train_epoch(0)
    assert tr.step == jtr.step == len(datasets[0].train_idx) // 256
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    check_params(jtr, tr)


def test_full_neighbor_tiny_trainset():
    """tests/test_flags.py's tiny trainset: a batch larger than the train
    split wraps around the epoch order, one full batch, as in JAX."""
    kw = dict(num_nodes=600, avg_degree=6, num_classes=4, feat_dim=16, seed=0)
    cfg = dict(TINY, batch_size=512)
    ds = synthetic_dataset(**kw)
    assert len(ds.train_idx) < 512
    tr = SageTrainer(ds, TrainConfig(**cfg), device="cpu")
    jtr = JaxTrainer(jax_synthetic(**kw), JaxConfig(steps_per_call=1, **cfg))
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    got, want = tr.train_epoch(0), jtr.train_epoch(0)
    assert np.isfinite(got["loss"]) and tr.step == 1
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_full_neighbor_trains_f32_under_bf16_flags(datasets, capsys):
    """JAX scopes --bf16 to the sampled trainers: a full-neighbor SAGE built
    with --bf16 --sparse runs its tower in f32 (and logs that the cores are
    routed), the same model as without the flags."""
    tr = SageTrainer(datasets[0], TrainConfig(**TINY, bf16=True, sparse=True), device="cpu")
    assert not tr.model.bf16 and not tr.fused_sparse
    assert "fused --sparse update needs sampled ids" in capsys.readouterr().err
    loss, _ = tr.full_neighbor_step(torch.arange(64))
    assert np.isfinite(float(loss))


def test_fit_and_cli_full_neighbor(datasets, tmp_path, capsys):
    res = SageTrainer(datasets[0], TrainConfig(**{**TINY, "batch_size": 512, "epochs": 2}),
                      device="cpu").fit()
    assert len(res["history"]) == 2 and np.isfinite(res["history"][-1]["loss"])
    from falcon_ttdforgnns_torch.cli import main
    main(["--device", "cpu", "--dataset", "tiny-test", "--synthetic-scale", "1.0",
          "--batch", "64", "--num-hidden", "16", "--num-layers", "2", "--tt-rank", "4,4",
          "--epochs", "1", "--full-neighbor", "--log-dir", str(tmp_path)])
    assert '"best"' in capsys.readouterr().out

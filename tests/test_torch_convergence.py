"""Convergence of the port's trainer on a small hard graph, as
tests/test_convergence.py asserts it of the JAX trainer: planted-partition
labels that need propagation (chance 1/4), 8 epochs.  The fused --sparse
update (fused Adam on the cores) must learn, reach at least 90% of routed
Adam's test accuracy, and fused SGD must not beat fused Adam (the default
routing of --sparse).  Step-math parity (tests/test_torch_trainer.py) cannot
show this: a few correct steps say nothing of whether the dynamics learn.
"""

import pytest

from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

NUM_CLASSES = 4  # chance 0.25
EPOCHS = 8


def run(ds, **kw):
    cfg = TrainConfig(batch_size=64, fanouts=(4, 4), epochs=EPOCHS, lr=0.01, dropout=0.0,
                      hidden_dim=32, num_layers=2, use_tt=True, tt_ranks=(4, 4),
                      weight_dist="normal", skip_eval=True, steps_per_call=4,
                      log_every=10000, seed=0, **kw)
    tr = SageTrainer(ds, cfg, device="cpu")
    for e in range(EPOCHS):
        tr.train_epoch(e)
    return tr, tr.evaluate()


@pytest.fixture(scope="module")
def results():
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=12, num_classes=NUM_CLASSES,
                                feat_dim=16, seed=0, homophily=0.9)
    _, routed = run(ds, sparse=False)
    tr_fused, fused = run(ds, sparse=True)
    assert tr_fused.fused_sparse, "fused step not selected"
    _, sgd = run(ds, sparse=True, tt_optimizer="sgd")
    return routed, fused, sgd


def test_routed_adam_learns(results):
    routed, _, _ = results
    assert routed["test_acc"] > 0.55, f"control failed to learn: {routed}"


def test_fused_leaves_chance(results):
    _, fused, _ = results
    assert fused["test_acc"] > 0.55, f"fused --sparse stalled near chance: {fused}"


def test_fused_matches_routed(results):
    routed, fused, _ = results
    assert fused["test_acc"] >= 0.9 * routed["test_acc"], \
        f"fused {fused['test_acc']:.4f} below 90% of routed {routed['test_acc']:.4f}"


def test_fused_sgd_does_not_beat_fused_adam(results):
    _, adam, sgd = results
    assert adam["test_acc"] >= sgd["test_acc"] - 0.05, \
        f"fused SGD beats fused Adam on a hard graph: {sgd} vs {adam}"

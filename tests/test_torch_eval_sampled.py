"""``--eval-sampled`` of the port (``SageTrainer.evaluate_sampled``) against
the JAX trainer's on a tiny graph, with the JAX variables carried into the
port by ``convert.load_jax_variables``: the same rng draws the same
subsamples and blocks (both samplers on their numpy path), so the split
accuracies are equal, but for predictions whose JAX top-2 logit margin is
under 1e-5 (f32 logits summed in another order may break such a tie the
other way).  Also the dispatch in ``evaluate`` and the host sampling under
``--mode puregpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph import sampler as jax_sampler
from falcon_ttdforgnns_tpu.graph.csr import hard_synthetic_dataset as jax_hard
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig

from falcon_ttdforgnns_torch.convert import load_jax_variables
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset, sampler
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

TINY = dict(batch_size=64, fanouts=(3, 4), hidden_dim=16, num_layers=2, tt_ranks=(4, 4),
            dropout=0.5, seed=0, eval_sampled=True, eval_sample_max=300)
MARGIN = 1e-5


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    return hard_synthetic_dataset(**kw), jax_hard(**kw)


def near_ties(jtr, seed: int = 1234) -> int:
    """Predictions of JAX's evaluate_sampled whose top-2 margin is under
    MARGIN: its rng and blocks, replayed."""
    cfg, ds = jtr.cfg, jtr.ds
    rng = np.random.default_rng(seed)
    ties = 0
    for idx in (ds.train_idx, ds.val_idx, ds.test_idx):
        if len(idx) > cfg.eval_sample_max:
            idx = rng.choice(idx, cfg.eval_sample_max, replace=False)
        B = cfg.batch_size
        for b in range(max(1, len(idx) // B)):
            pick = jtr._wrap_full(idx[b * B:(b + 1) * B], idx, B)
            blk = jax_sampler.sample_block(ds.graph, pick, cfg.fanouts, rng)
            logits = np.asarray(jtr.model.apply(jtr.variables, jnp.asarray(blk.seeds),
                                                [jnp.asarray(l) for l in blk.layers],
                                                train=False))
            top2 = np.sort(logits, axis=-1)[:, -2:]
            ties += int((top2[:, 1] - top2[:, 0] < MARGIN).sum())
    return ties


@pytest.mark.parametrize("kw", [dict(), dict(mode="puregpu", sparse=True), dict(cache_size=64)],
                         ids=["mixed", "puregpu", "cache"])
def test_evaluate_sampled_matches_jax(datasets, monkeypatch, kw):
    monkeypatch.setattr(sampler, "_native", None)
    monkeypatch.setattr(jax_sampler, "_native", None)
    ds, jds = datasets
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **{**TINY, **kw}))
    tr = SageTrainer(ds, TrainConfig(**{**TINY, **kw}), device="cpu")
    variables = jax.tree.map(np.asarray, jtr.variables)
    if kw.get("cache_size"):  # a populated cache, so the lookup takes some rows from it
        freq = np.bincount(ds.graph.indices, minlength=ds.num_nodes).astype(np.int32)
        jtr.loader.freq = freq
        jtr.maybe_populate_cache()
        variables = jax.tree.map(np.asarray, jtr.variables)
    load_jax_variables(tr, variables)
    want = jtr.evaluate()  # the dispatch: --eval-sampled
    got = tr.evaluate()
    assert set(got) == set(want) == {"train_acc", "val_acc", "test_acc"}
    ties = near_ties(jtr)
    assert ties <= 2  # the comparison below is (nearly) exact
    # each split (1200, 400, 400 ids) is cut to 300, then 4 batches of 64
    for k in want:
        assert abs(got[k] - want[k]) * 256 <= ties, (k, got[k], want[k], ties)
    assert got == tr.evaluate_sampled(seed=1234)  # deterministic in its seed


def test_split_sizes_and_subsample(datasets, monkeypatch):
    """Splits over eval_sample_max are subsampled; a split smaller than a
    batch still makes one full batch (wrapped around)."""
    ds, _ = datasets
    calls = []
    real = sampler.sample_block

    def counted(graph, seeds, fanouts, rng):
        calls.append(len(seeds))
        return real(graph, seeds, fanouts, rng)

    import falcon_ttdforgnns_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "sample_block", counted)
    tr = SageTrainer(ds, TrainConfig(**{**TINY, "batch_size": 512, "eval_sample_max": 1000}),
                     device="cpu")
    res = tr.evaluate_sampled()
    # train: 1200 ids cut to 1000, 1 batch; val and test: 400 ids, 1 wrapped batch each
    assert calls == [512, 512, 512]
    assert all(0.0 <= v <= 1.0 for v in res.values())

"""The port's dense-param Adam and ReduceLROnPlateau against optax and the
JAX package's branch-free plateau (cf. tests/test_optimizer_routing.py:161)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from falcon_ttdforgnns_tpu.train.optim import reduce_on_plateau as jax_plateau

from falcon_ttdforgnns_torch.train.optim import (adam_init, adam_update,
                                                 auto_plateau_patience,
                                                 plateau_init, reduce_on_plateau)

LOSSES = [1.0, 0.9, 0.95, 0.94, 0.93, 0.92, 0.5, 0.6, 0.6, 0.6, 0.61, 0.6, 0.59,
          0.7, 0.8, 0.9, 1.0, 1.1]


@pytest.mark.parametrize("smoothing", [0.0, 0.25])
def test_plateau_scale_sequence_matches(smoothing):
    """The same loss sequence gives the same scale sequence, bit for bit."""
    tx = jax_plateau(patience=3, factor=0.5, smoothing=smoothing)
    js = tx.init(None)
    ts = plateau_init("cpu")
    scales = []
    for v in LOSSES:
        _, js = tx.update({"w": jnp.zeros(2)}, js, None, value=v)
        ts = reduce_on_plateau(ts, torch.tensor(v), patience=3, factor=0.5,
                               smoothing=smoothing)
        assert float(ts.scale) == float(js.scale)
        assert float(ts.best_value) == float(js.best_value)
        assert int(ts.plateau_count) == int(js.plateau_count)
        scales.append(float(ts.scale))
    assert min(scales) < 1.0  # the ratchet actually fired


def test_auto_patience():
    assert auto_plateau_patience(-1) == 800
    assert auto_plateau_patience(0) == 0
    assert auto_plateau_patience(5) == 5


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_with_plateau_scale_matches_optax(wd):
    """adam_update(scale) == optax.adam/adamw chained with a scale."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    inner = optax.adamw(0.01, weight_decay=wd) if wd else optax.adam(0.01)
    jp = [jnp.asarray(p) for p in p0]
    st = inner.init(jp)
    tp = [torch.tensor(p) for p in p0]
    ts = adam_init(tp)
    for step, scale in enumerate([1.0, 0.5, 0.5]):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        u, st = inner.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, [scale * x for x in u])
        adam_update(tp, [torch.tensor(x) for x in g], ts, 0.01, torch.tensor(scale), wd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert int(ts.count) == 3

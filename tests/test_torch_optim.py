"""The port's dense-param Adam, routed TT-core optimizers and
ReduceLROnPlateau against optax and the JAX package's transforms and
branch-free plateau (cf. tests/test_optimizer_routing.py:161)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_jax_native import ensure_jax_native

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.train.optim import reduce_on_plateau as jax_plateau
from falcon_ttdforgnns_tpu.train.optim import rowwise_adagrad as jax_rowwise_adagrad
from falcon_ttdforgnns_tpu.train.optim import tt_adagrad as jax_tt_adagrad

from falcon_ttdforgnns_torch.ops import adam
from falcon_ttdforgnns_torch.train.optim import (adam_init, adam_plain, adam_update,
                                                 auto_plateau_patience, bias_corrections,
                                                 core_update, plateau_init,
                                                 reduce_on_plateau, tt_acc_init)

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
    # under a bf16 tower auto is off (JAX trainer.py:248-259); explicit wins
    assert auto_plateau_patience(-1, bf16_tower=True) == 0
    assert auto_plateau_patience(7, bf16_tower=True) == 7


@pytest.mark.parametrize("name", ["sgd", "adagrad", "rowwise_adagrad"])
def test_routed_core_optimizers_match_jax(name):
    """core_update == the JAX package's routed transform (optax.sgd,
    optim.tt_adagrad, optim.rowwise_adagrad) followed by the plateau
    scale, over three steps with the state threaded on each side."""
    rng = np.random.default_rng(1)
    shapes = [(5, 1, 3, 4), (6, 4, 2, 1)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr = 0.01
    tx = {"sgd": optax.sgd(lr), "adagrad": jax_tt_adagrad(lr),
          "rowwise_adagrad": jax_rowwise_adagrad(lr)}[name]
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [torch.tensor(p) for p in p0]
    accs = tt_acc_init(tp, name)
    assert (accs is None) == (name == "sgd")
    for scale in (1.0, 0.5, 0.25):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        u, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, [scale * x for x in u])
        core_update(tp, [torch.tensor(x) for x in g], accs, name, lr, torch.tensor(scale))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    if accs is not None:
        for a, b in zip(accs, st):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


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


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("scale", [torch.tensor(0.5), 1.0], ids=["tensor", "float"])
def test_adam_update_on_cpu_is_the_plain_body(wd, scale):
    """On CPU tensors adam_update launches no kernel and leaves p, m and v
    equal, bit for bit, to its plain body run after the same count and
    bias corrections, over three steps."""
    gen = torch.Generator().manual_seed(4)
    shapes = [(6, 5), (7,), (3, 1, 3)]
    got = [torch.randn(s, generator=gen) for s in shapes]
    want = [p.clone() for p in got]
    sg, sw = adam_init(got), adam_init(want)
    adam.reset_launch_counts()
    for _ in range(3):
        grads = [torch.randn(s, generator=gen) for s in shapes]
        adam_update(got, grads, sg, 0.01, scale, wd)
        sw.count += 1
        adam_plain(want, grads, sw.m, sw.v, *bias_corrections(sw.count), 0.01, scale, wd)
    assert adam.launch_counts() == {"adam_f32": 0}
    for a, b in zip(got + sg.m + sg.v, want + sw.m + sw.v):
        assert torch.equal(a, b)
    assert int(sg.count) == 3


def test_adam_f32_apply_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper takes CUDA tensors only (their plain version is
    adam_update's body) and lists of one length."""
    p = [torch.zeros(4)]
    bc = bias_corrections(torch.ones((), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        adam.adam_f32_apply(p, p, p, p, *bc, 0.01, 1.0, 0.0, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError, match="grads"):
        adam.adam_f32_apply(p, p + p, p, p, *bc, 0.01, 1.0, 0.0, 0.9, 0.999, 1e-8)
    adam.adam_f32_apply([], [], [], [], *bc, 0.01, 1.0, 0.0, 0.9, 0.999, 1e-8)
    assert adam.launch_counts()["adam_f32"] == 0

"""Card-only tests of the dense parameters' Adam kernel ``adam_f32``
(``csrc/optim_kernels.cu``, wrapper ``ops/adam.py``): ``adam_update`` on
CUDA tensors against its plain body (``adam_plain``) run on the same card
tensors, bit for bit (``torch.equal``) over 3 steps, the wrapper's input
checks, and one launch a step from every caller: the routed update
(``SageTrainer._apply_update``), the fused ``--sparse`` step, its
``--dist`` branch and the full-graph trainer.  Every test carries the
``cuda`` marker and, without a CUDA device, skips (decided in a fixture,
at run time).  This file imports neither jax nor the JAX package, so it
runs on the card:

    python -m pytest tests/test_torch_cuda_optim.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from falcon_ttdforgnns_torch.ops import adam
from falcon_ttdforgnns_torch.ops.adam import adam_f32_apply
from falcon_ttdforgnns_torch.train.optim import (AdamState, adam_init, adam_plain,
                                                 adam_update, bias_corrections)

pytestmark = pytest.mark.cuda

# numel 32,772 spans two of the kernel's 16,384-value blocks and a float4
# tail; 257 and 21 are no multiple of 4; (257,) and (5,) are biases
SHAPES = [(1000, 100), (257,), (3, 7), (32772,), (64, 33), (5,)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_params(shapes, dev, seed, misaligned=False):
    """Parameters drawn from ``seed``; with ``misaligned`` the last one a
    view starting 4 bytes past a 16-byte boundary (the kernel's scalar path)."""
    gen = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    if misaligned:
        buf = torch.empty(params[-1].numel() + 1, device=dev)
        buf[1:] = params[-1].reshape(-1)
        params[-1] = buf[1:].view(params[-1].shape)
        assert params[-1].data_ptr() % 16 == 4
    return params


def plain_step(params, grads, state, lr, scale, wd):
    """adam_update's count and bias corrections, then its plain body."""
    state.count += 1
    bc1, bc2 = bias_corrections(state.count)
    adam_plain(params, grads, state.m, state.v, bc1, bc2, lr, scale, wd)


def run_both(params, dev, steps, lr, scale, wd, seed):
    """`steps` steps of adam_update (the kernel) and of the plain body from
    the same parameters and gradients; both sides' (params, state)."""
    got = [p.clone() for p in params]
    want = [p.clone() for p in params]
    sg, sw = adam_init(got), adam_init(want)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        grads = [torch.randn(p.shape, generator=gen).to(dev) for p in params]
        adam_update(got, grads, sg, lr, scale, wd)
        plain_step(want, grads, sw, lr, scale, wd)
    return (got, sg), (want, sw)


def assert_equal(got, sg, want, sw):
    for k in range(len(got)):
        assert torch.equal(got[k], want[k]), f"param {k}"
        assert torch.equal(sg.m[k], sw.m[k]), f"m {k}"
        assert torch.equal(sg.v[k], sw.v[k]), f"v {k}"
    assert int(sg.count) == int(sw.count)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("scale", ["tensor 0.5", "float 1.0"])
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
def test_adam_f32_bit_identical_to_plain(cuda, wd, scale, misaligned):
    """3 steps over six tensors (a bias, numels off a multiple of 4, one
    across blocks with a tail; with ``misaligned`` one 4 bytes off a 16-byte
    boundary): p, m and v equal to the plain body's bit for bit, the
    parameters moved, one launch a step."""
    params = make_params(SHAPES, cuda, 7, misaligned)
    s = torch.full((), 0.5, device=cuda) if scale.startswith("tensor") else 1.0
    adam.reset_launch_counts()
    (got, sg), (want, sw) = run_both(params, cuda, 3, 0.003, s, wd, 11)
    assert adam.launch_counts()["adam_f32"] == 3
    assert_equal(got, sg, want, sw)
    for a, b in zip(got, params):
        assert not torch.equal(a, b)


def test_adam_f32_over_more_tensors_than_one_launch_takes(cuda):
    """70 tensors, past the kernel's 64 a launch: two launches a step, and
    still the plain body's bits."""
    shapes = [(int(n),) for n in np.random.default_rng(3).integers(1, 300, 70)]
    params = make_params(shapes, cuda, 5)
    adam.reset_launch_counts()
    (got, sg), (want, sw) = run_both(params, cuda, 3, 0.01, torch.ones((), device=cuda),
                                     0.0, 13)
    assert adam.launch_counts()["adam_f32"] == 2 * 3
    assert_equal(got, sg, want, sw)


def test_adam_f32_empty_tensors_launch_nothing(cuda):
    """Tensors without values take no block; a list of them no launch."""
    params = [torch.empty(0, device=cuda), torch.randn(9, device=cuda),
              torch.empty(0, 4, device=cuda)]
    adam.reset_launch_counts()
    (got, sg), (want, sw) = run_both(params, cuda, 2, 0.01, 1.0, 0.0, 17)
    assert_equal(got, sg, want, sw)
    assert adam.launch_counts()["adam_f32"] == 2
    empty = [params[0]]
    adam_update(empty, [torch.empty(0, device=cuda)], adam_init(empty), 0.01, 1.0)
    assert adam.launch_counts()["adam_f32"] == 2


def test_adam_f32_input_checks(cuda):
    p = torch.randn(8, device=cuda)
    st = adam_init([p])
    bc1, bc2 = bias_corrections(st.count + 1)
    args = (bc1, bc2, 0.01, 1.0, 0.0, 0.9, 0.999, 1e-8)
    g = torch.randn(8, device=cuda)
    with pytest.raises(TypeError):  # f16 parameter
        adam_f32_apply([p.half()], [g.half()], [st.m[0].half()], [st.v[0].half()], *args)
    with pytest.raises(ValueError):  # shape
        adam_f32_apply([p], [torch.randn(9, device=cuda)], st.m, st.v, *args)
    with pytest.raises(ValueError):  # contiguity
        q = torch.randn(4, 4, device=cuda)
        adam_f32_apply([q], [torch.randn(4, 4, device=cuda).t()], [torch.zeros_like(q)],
                       [torch.zeros_like(q)], *args)
    with pytest.raises(ValueError):  # a CPU gradient
        adam_f32_apply([p], [g.cpu()], st.m, st.v, *args)
    with pytest.raises(ValueError):  # a CPU scale tensor
        adam_f32_apply([p], [g], st.m, st.v, bc1, bc2, 0.01, torch.ones(()), 0.0, 0.9,
                       0.999, 1e-8)
    with pytest.raises(TypeError):  # an f64 bias correction
        adam_f32_apply([p], [g], st.m, st.v, bc1.double(), bc2, 0.01, 1.0, 0.0, 0.9, 0.999,
                       1e-8)
    with pytest.raises(ValueError):  # lists of other lengths
        adam_f32_apply([p], [g, g], st.m, st.v, *args)
    with pytest.raises(ValueError):  # mixed devices through adam_update
        adam_update([p, torch.randn(3)], [g, torch.randn(3)],
                    AdamState([st.m[0], torch.zeros(3)], [st.v[0], torch.zeros(3)], st.count),
                    0.01, 1.0)


def tiny_trainer(**kw):
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4,
                                feat_dim=16, seed=0)
    return SageTrainer(ds, TrainConfig(batch_size=64, fanouts=(3, 3), hidden_dim=16,
                                       num_layers=2, tt_ranks=(4, 4), **kw), device="cuda")


@pytest.mark.parametrize("kw", [dict(use_tt=False), dict(sparse=True),
                                dict(mode="puregpu", use_tt=False, steps_per_call=2)],
                         ids=["routed-no-tt", "fused-sparse", "puregpu-no-tt"])
def test_trainer_steps_launch_adam_f32_once_a_step(cuda, kw):
    """The dense cell's step (--no-tt: _apply_update over the table and the
    tower) and the fused --sparse step: one adam_f32 launch a step."""
    tr = tiny_trainer(**kw)
    adam.reset_launch_counts()
    if kw.get("mode") == "puregpu":
        import dataclasses
        tr.ds = dataclasses.replace(tr.ds, train_idx=tr.ds.train_idx[:256])
        tr.train_epoch(0)
        steps = 4
    else:
        for steps, b in enumerate(tr.loader, 1):
            loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
            assert np.isfinite(float(loss))
            if steps == 3:
                break
    assert adam.launch_counts()["adam_f32"] == steps
    assert int(tr.opt_state.count) == steps


def test_dist_fused_step_launches_adam_f32(cuda, tmp_path):
    """--dist --sparse through a one-rank NCCL group: the data-parallel
    step's dense update is one adam_f32 launch a step."""
    import dataclasses

    import torch.distributed as dist

    from falcon_ttdforgnns_torch.parallel import init_process_group
    from falcon_ttdforgnns_torch.train import SageTrainer
    init_process_group("cuda", "file://" + str(tmp_path / "store"), 0, 1, local_rank=0)
    try:
        one = tiny_trainer(mode="puregpu", sparse=True, steps_per_call=2, dist=True)
        dp = SageTrainer(one.ds, one.cfg, device=cuda, group=dist.group.WORLD)
        dp.ds = dataclasses.replace(dp.ds, train_idx=dp.ds.train_idx[:256])
        adam.reset_launch_counts()
        dp.train_epoch(0)
    finally:
        dist.destroy_process_group()
    assert dp.dp is not None
    assert adam.launch_counts()["adam_f32"] == 4


def test_full_graph_step_launches_adam_f32(cuda):
    """FullGraphTrainer's AdamW step (a float scale of 1.0, weight decay):
    one launch a step."""
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import FullGraphConfig, FullGraphTrainer
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16,
                                seed=0)
    tr = FullGraphTrainer(ds, FullGraphConfig(model="gcn", hidden_dim=16, num_layers=2,
                                              tt_ranks=(4, 4), weight_decay=0.01))
    adam.reset_launch_counts()
    for e in range(2):
        assert np.isfinite(tr.train_epoch(e)["loss"])
    assert adam.launch_counts()["adam_f32"] == 2

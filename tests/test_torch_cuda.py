"""Card-only tests of the port's CUDA kernels: each kernel against its
plain version, the wrappers' input checks, TTLookup's autograd on the card,
and a train step that launches every kernel.  Without a CUDA device every
test here skips (the decision is made in a fixture, at run time).  This
file imports neither jax nor the JAX package, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from falcon_ttdforgnns_torch.ops import tt_init, tt_kernels
from falcon_ttdforgnns_torch.ops.tt_kernels import (TTLookup, tt_adam_apply,
                                                    tt_fwd, tt_grads)
from falcon_ttdforgnns_torch.ops.tt_shapes import TTShapes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(ndim, dev):
    shapes = {2: TTShapes(256, 64, (16, 16), (8, 8), (12,)),
              3: TTShapes(1680, 60, (10, 12, 14), (3, 4, 5), (8, 8)),
              4: TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))}[ndim]
    return shapes, [torch.tensor(c, device=dev)
                    for c in tt_init.init_tt_cores(shapes, "normal", 0)]


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_kernels_match_plain(cuda, ndim):
    """Tolerances on max|kernel - plain| / max|plain|: 1e-5 for the lookup
    and the Adam update (same f32 arithmetic, other FMA contraction), 1e-4
    for the gradients (atomics reorder the sums)."""
    shapes, cores = case(ndim, cuda)
    rng = np.random.default_rng(50 + ndim)
    ids = rng.integers(0, shapes.num_embeddings, 1001).astype(np.int32)
    ids[500:516] = ids[:16]
    ids = torch.tensor(ids, device=cuda)
    g = torch.tensor(rng.normal(size=(1001, shapes.embedding_dim)).astype(np.float32),
                     device=cuda)
    tt_kernels.reset_launch_counts()
    assert rel_err(tt_fwd(shapes, cores, ids), tt_kernels.tt_fwd_plain(shapes, cores, ids)) <= 1e-5
    for a, b in zip(tt_grads(shapes, cores, ids, g),
                    tt_kernels.tt_grads_plain(shapes, cores, ids, g)):
        assert rel_err(a, b) <= 1e-4
    grads = [torch.randn(c.shape, device=cuda) for c in cores]
    scal = torch.tensor([0.01, 10.0, 1000.0], device=cuda)

    def state():
        return ([c.clone() for c in cores], [torch.zeros_like(c) for c in cores],
                [torch.zeros_like(c) for c in cores])

    got, want = state(), state()
    tt_adam_apply(*got, grads, scal, 0.9, 0.999, 1e-8)
    tt_kernels.tt_adam_plain(*want, grads, scal, 0.9, 0.999, 1e-8)
    for k, old in enumerate(cores):
        # the cores by their change, so a missing update cannot pass
        assert rel_err(got[0][k] - old, want[0][k] - old) <= 1e-5
        assert rel_err(got[1][k], want[1][k]) <= 1e-5
        assert rel_err(got[2][k], want[2][k]) <= 1e-5
    assert tt_kernels.launch_counts() == {"tt_fwd": 1, "tt_grads": 1, "tt_adam_apply": 1}


def test_ttlookup_backward_on_card(cuda):
    shapes, cores = case(3, cuda)
    cores = [c.requires_grad_(True) for c in cores]
    ids = torch.randint(0, shapes.num_embeddings, (300,), dtype=torch.int32, device=cuda)
    g = torch.randn(300, shapes.embedding_dim, device=cuda)
    TTLookup.apply(shapes, ids, *cores).backward(g)
    want = tt_kernels.tt_grads_plain(shapes, [c.detach() for c in cores], ids, g)
    for c, w in zip(cores, want):
        assert rel_err(c.grad, w) <= 1e-4


def test_wrappers_raise_on_bad_input(cuda):
    shapes, cores = case(3, cuda)
    with pytest.raises(TypeError):
        tt_fwd(shapes, cores, torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        tt_fwd(shapes, cores, torch.zeros(4, dtype=torch.int32))  # ids on the CPU
    with pytest.raises(ValueError):
        tt_fwd(shapes, [c.transpose(0, 1) for c in cores],
               torch.zeros(4, dtype=torch.int32, device=cuda))


def test_train_step_launches_every_kernel(cuda):
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4,
                                feat_dim=16, seed=0)
    tr = SageTrainer(ds, TrainConfig(batch_size=64, fanouts=(3, 3), hidden_dim=16,
                                     num_layers=2, tt_ranks=(4, 4), sparse=True))
    b = next(iter(tr.loader))
    tt_kernels.reset_launch_counts()
    loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
    assert np.isfinite(float(loss))
    assert tt_kernels.launch_counts() == {"tt_fwd": 1, "tt_grads": 1, "tt_adam_apply": 1}
    assert 0.0 <= tr.evaluate()["test_acc"] <= 1.0

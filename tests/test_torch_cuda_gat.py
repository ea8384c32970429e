"""Card-only tests of the CSR attention kernels ``csr_gat_bf16`` and
``csr_gat_f32`` (``csrc/attn_kernels.cu``) against their plain version run
on CPU copies, and of the sampled GAT's evaluate() and train step on the
card against the same on the CPU.  Every test carries the ``cuda`` marker
and, without a CUDA device, skips (decided in a fixture, at run time).
This file imports neither jax nor the JAX package, so it runs on the card:

    python -m pytest tests/test_torch_cuda_gat.py -q --noconftest

Tolerances: each row's softmax and weighted sum run in another order on
the card (lanes, FMA contraction, ``expf``), so f32 results agree to 1e-5
of the largest value; a bf16 result is the f32 one rounded once, so it
lies within one bf16 step (2^-8 relative) of the plain version's f32
value.
"""

import numpy as np
import pytest
import torch

from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.ops import attention
from falcon_ttdforgnns_torch.ops.attention import csr_gat, csr_gat_plain
from falcon_ttdforgnns_torch.ops.segment import edges_by_row
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def graph(n: int, seed: int):
    """Row 0 without in-edges, row 1 of degree 1, row 2 of degree 40, row 3
    of degree 300, the rest 0-60 (a row's edges run past several of the
    kernel's 4-edge loads and its 32 lanes); (src, dst) int64, dst sorted."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 61, n)
    deg[:4] = (0, 1, 40, 300)
    return (torch.as_tensor(rng.integers(0, n, int(deg.sum()))),
            torch.as_tensor(np.repeat(np.arange(n), deg)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,cp,mean", [(4, 128, False), (4, 48, True), (4, 8, False),
                                           (2, 16, True), (2, 256, False)])
def test_csr_gat_matches_plain(cuda, dtype, heads, cp, mean):
    n = 3000
    edges = graph(n, heads * cp)
    index = edges_by_row(*edges, n)
    gen = torch.Generator().manual_seed(cp)
    x = torch.randn(n + 5, heads * cp, generator=gen).to(dtype)  # rows past n: sources only
    el = torch.randn(n + 5, heads, generator=gen) * 2
    er = torch.randn(n, heads, generator=gen) * 2
    want = csr_gat_plain(x.float(), el, er, index.src, index.indptr, heads, mean)
    attention.reset_launch_counts()
    got = csr_gat(*(t.to(cuda) for t in (x, el, er)),
                  edges_by_row(*(t.to(cuda) for t in edges), n), heads, mean).cpu()
    name = "csr_gat_bf16" if dtype == torch.bfloat16 else "csr_gat_f32"
    assert attention.launch_counts()[name] == 1
    assert got.dtype == dtype and got.shape == want.shape
    scale = float(want.abs().max())
    tol = 1e-5 * scale + (2.0 ** -8 * want.abs() if dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - want).abs() <= tol).all()), float((got.float() - want).abs().max())
    # the row without in-edges is its own row
    self0 = x[0].float().reshape(heads, cp)
    torch.testing.assert_close(got[0].float(), self0.mean(0) if mean else x[0].float(),
                               rtol=2.0 ** -8, atol=1e-6)


def test_csr_gat_refuses_what_it_cannot_take(cuda):
    """A head the kernel cannot load, and a source past the rows, which the
    index refuses when it is built on the card, before any kernel runs."""
    src, dst = (t.to(cuda) for t in graph(100, 0))
    x = torch.randn(100, 4 * 47, device=cuda).bfloat16()
    el, er = torch.randn(100, 4, device=cuda), torch.randn(100, 4, device=cuda)
    with pytest.raises(ValueError, match="multiple"):  # a head of 47 values: pad it
        csr_gat(x, el, er, edges_by_row(src, dst, 100), 4, True)
    bad = src.clone()
    bad[0] = 100
    with pytest.raises(ValueError, match="src spans"):
        edges_by_row(bad, dst, 100)


@pytest.mark.parametrize("bf16", [False, True])
def test_gat_evaluate_and_step_on_the_card_match_the_cpu(cuda, bf16):
    """The sampled GAT (4 heads of 16, the last layer's 5 classes padded to
    8) through SageTrainer: evaluate()'s logits on the card against the CPU's
    (f32 1e-4 of the logits' norm: reassociation through three layers;
    bf16 2e-2: the card's bf16 GEMMs and the kernel round elsewhere than
    the CPU), one launch of the kernel a layer, then one --mode puregpu
    --sparse step's loss on each side from the same weights and levels
    (no dropout: the two sides' generators draw other masks)."""
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=10, num_classes=5, feat_dim=16,
                                seed=1, split_counts=(600, 300, 600))
    kw = dict(model="gat", num_heads=4, hidden_dim=16, num_layers=3, fanouts=(3, 3, 3),
              batch_size=64, tt_ranks=(4, 4), p_shapes=(10, 15, 20), q_shapes=(4, 2, 2),
              sparse=True, mode="puregpu", bf16=bf16, dropout=0.0, seed=3)
    trs = {d: SageTrainer(ds, TrainConfig(**kw), device=d) for d in ("cpu", "cuda")}
    with torch.no_grad():
        for p, q in zip(trs["cpu"].model.parameters(), trs["cuda"].model.parameters()):
            q.copy_(p)
    logits = {}
    for d, tr in trs.items():
        attention.reset_launch_counts()
        with torch.no_grad():
            logits[d] = tr.model.forward_full_graph(tr._full_graph()).cpu()
    assert attention.launch_counts()["csr_gat_bf16" if bf16 else "csr_gat_f32"] == 3
    gap = float((logits["cuda"] - logits["cpu"]).norm() / logits["cpu"].norm())
    assert gap <= (2e-2 if bf16 else 1e-4), gap
    seeds = torch.as_tensor(ds.train_idx[:64].astype(np.int64))
    labels = torch.as_tensor(ds.labels[ds.train_idx[:64]].astype(np.int64))
    layers = trs["cpu"].sample_layers(seeds)
    losses = {d: float(tr._step(seeds.to(tr.device), [l.to(tr.device) for l in layers],
                                labels.to(tr.device))[0]) for d, tr in trs.items()}
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-2 if bf16 else 1e-4)

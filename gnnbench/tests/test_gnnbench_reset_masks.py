"""The recorded first steps of a train cell start from set-up's state and
follow the program's own dropout draws: ``reset_state`` restores a model's
buffers (a BatchNorm's running statistics) as ``build_trainer`` left them,
and ``StepRecorder`` reads each dropout mask from the draw itself, so that
a kept value that is exactly 0 (as ELU or a bf16 sum can make) reads as
kept."""

import json

import pytest
import torch
import torch.nn.functional as F

from falcon_ttdforgnns_torch.models.sage import SAGE
from falcon_ttdforgnns_torch.nn.layers import BatchNorm, dropout
from gnnbench import harness
from gnnbench.graph import load_graph
from gnnbench.tests.cells import make_root


@pytest.fixture
def normed(tmp_path, monkeypatch):
    """The tiny dense train cell's trainer, its model given a BatchNorm
    whose running statistics start away from their defaults."""
    init = SAGE.__init__

    def with_norm(self, *args, **kw):
        init(self, *args, **kw)
        self.norm = BatchNorm(4)
        self.norm.running_mean.fill_(0.25)
        self.norm.running_var.fill_(2.0)

    monkeypatch.setattr(SAGE, "__init__", with_norm)
    root = make_root(tmp_path, limits="loose")
    cell = harness.load_cell(root, "sage-dense-tiny.train")
    g = load_graph(cell.config["graph"], root / "gnnbench" / "cache")
    weights = cell.ref.make_weights(cell.config, g.num_nodes, g.num_classes, 3, "cpu")
    weights.update({"norm.weight": torch.full((4,), 1.5), "norm.bias": torch.full((4,), 0.1)})
    tr = harness.build_trainer(harness.dataset_of(g, "tiny"), cell.config, cell.traffic, 3,
                               weights, "cpu")
    return tr, weights


def test_reset_state_restores_the_buffers_build_trainer_left(normed):
    tr, weights = normed
    with torch.no_grad():  # the state a few steps leave
        tr.model.norm(torch.randn(32, 4) * 3 + 1, train=True)
        for p in tr.model.parameters():
            p.add_(1.0)
        for m in tr.opt_state.m:
            m.fill_(1.0)
    tr.step = 5
    assert not torch.equal(tr.model.norm.running_mean, torch.full((4,), 0.25))
    harness.reset_state(tr, weights)
    assert torch.equal(tr.model.norm.running_mean, torch.full((4,), 0.25))
    assert torch.equal(tr.model.norm.running_var, torch.full((4,), 2.0))
    params = dict(tr.model.named_parameters())
    assert all(torch.equal(params[n], w) for n, w in weights.items())
    assert tr.step == 0 and all(int(m.abs().sum()) == 0 for m in tr.opt_state.m)


def test_reset_state_refuses_a_buffer_it_did_not_keep(normed):
    tr, weights = normed
    tr.model.register_buffer("late", torch.zeros(3))
    with pytest.raises(harness.CellError, match="buffers"):
        harness.reset_state(tr, weights)


def recorder():
    rec = harness.StepRecorder.__new__(harness.StepRecorder)
    rec._cur = {"masks": []}
    return rec


@pytest.mark.parametrize("p", [0.5, 0.2])
def test_a_kept_zero_reads_as_kept(p):
    """ELU's output is exactly 0 where its input is: the mask is the draw's,
    the program's draws are those it makes unrecorded, and ``out != 0``
    would have read every kept zero as dropped."""
    g0 = torch.Generator().manual_seed(0)
    h = F.elu(torch.randn(64, 32, generator=g0) * (torch.rand(64, 32, generator=g0) < 0.5))
    assert int((h == 0).sum()) > 100
    rec = recorder()
    drop = rec._recording(dropout)
    gen = torch.Generator().manual_seed(7)
    out = drop(h, p, True, gen)
    mask = rec._cur["masks"][0]
    twin = torch.Generator().manual_seed(7)
    want = torch.rand(h.shape, generator=twin) < 1.0 - p
    assert torch.equal(mask, want)
    assert torch.equal(out, dropout(h, p, True, torch.Generator().manual_seed(7)))
    assert torch.equal(gen.get_state(), twin.get_state())  # the program's stream moved as before
    assert bool((mask & (h == 0)).any())
    assert not torch.equal(mask, out != 0)


def test_a_default_generator_is_followed_too():
    h = torch.relu(torch.randn(40, 8, generator=torch.Generator().manual_seed(1)))
    rec = recorder()
    torch.manual_seed(3)
    out = rec._recording(dropout)(h, 0.5, True, None)
    torch.manual_seed(3)
    assert torch.equal(rec._cur["masks"][0], torch.rand(h.shape) < 0.5)
    torch.manual_seed(3)
    assert torch.equal(out, dropout(h, 0.5, True, None))
    assert rec._recording(dropout)(h, 0.5, False, None) is h  # eval: nothing drawn
    assert len(rec._cur["masks"]) == 1


def test_a_gat_train_step_follows_its_masks_through_elu(tmp_path):
    """GAT drops out after ELU, and its bf16 sums make exact zeros that
    were kept: with the masks read from the draw, the tiny GAT's first
    gradients agree with the reference's to ~0.006 of a leaf's norm on the
    CPU (``out != 0`` read 0.026-0.036 on these seeds)."""
    root = make_root(tmp_path, limits="loose")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gat-tt-tiny.train", "config": "gat-tt-tiny",
                               "traffic": "train", "chips": 1, "why": "the GAT tower trained"})
    for m in bench["end_to_end"]:
        if "sage-dense-tiny.train" in m.get("workloads", []):
            m["workloads"].append("gat-tt-tiny.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "gnnbench" / "limits" / "gat-tt-tiny.train.json").write_text(
        json.dumps({"grad_diff": 0.015, "tree_faults": 0}))
    for seed in (3, 5):
        out = harness.run_cell(root, "gat-tt-tiny.train", seed, 0.0, False, device="cpu")
        assert out["correct"] is True, (seed, out["checks"])

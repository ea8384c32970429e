"""A configuration names its architecture's module, and the harness reaches
the model through it alone: a tiny cell whose configuration names a probe
module (``ref_probe.py``) runs through the probe, and a reference that
cannot serve is refused before the graph is built."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnbench import harness, readers
from gnnbench.tests.cells import make_root

PROBE = "gnnbench/tests/ref_probe.py"
SEED = 2**31 + 29


def run(monkeypatch, root, workload, **kw):
    """One run on the CPU, and the cell it loaded."""
    cells = []
    load = harness.load_cell

    def spy(*args):
        cells.append(load(*args))
        return cells[-1]

    monkeypatch.setattr(harness, "load_cell", spy)
    out = harness.run_cell(root, workload, SEED, 0.0, False, device="cpu", **kw)
    monkeypatch.setattr(harness, "load_cell", load)
    return out, cells[0]


def test_a_cell_runs_through_the_module_its_configuration_names(tmp_path, monkeypatch):
    root = make_root(tmp_path / "probe", limits="loose", reference=PROBE)
    out, cell = run(monkeypatch, root, "sage-dense-tiny.train")
    probe, calls = cell.ref, cell.ref.CALLS
    assert probe.__file__.endswith("ref_probe.py") and out["correct"] is True
    loaded = {n: 1 for n in probe.CONSTANTS}  # the interface's check reads each once
    # the weights, the readings, the masks' shapes, Adam's b1, the dropout sites
    assert calls["make_weights"] == 3 and calls["train_readings"] == 1
    assert calls["mask_shapes"] == 3  # a recorded step each
    assert calls["ADAM_B1"] > loaded["ADAM_B1"]
    assert calls["DROPOUT_SITES"] > loaded["DROPOUT_SITES"]
    # the same cell through reference/sage.py reads the same numbers
    same, _ = run(monkeypatch, make_root(tmp_path / "sage", limits="loose"),
                  "sage-dense-tiny.train")
    assert same["checks"] == out["checks"]

    # an eval cell's logits and its control
    calls.clear()
    out, cell = run(monkeypatch, root, "sage-tt-tiny.eval", control="fp8")
    calls = cell.ref.CALLS
    assert calls["full_graph_logits"] >= 2 and calls["CONTROLS"] > 1

    # the level ids and the FLOPs that train_mfu and eval_mfu divide by
    ref = cell.ref
    seeds, layers = torch.arange(4), [torch.arange(8), torch.arange(24)]
    tctx = SimpleNamespace(ref=ref, steps=0, step_ids=[])
    trainer = SimpleNamespace(_step=lambda *args: None)
    harness._count_steps(trainer, tctx)
    trainer._step(seeds, layers, None)
    assert calls["level_ids"] == 1 and tctx.step_ids[0].numel() == 36
    g = SimpleNamespace(num_nodes=100, num_edges=1000, num_classes=8,
                        train_idx=np.arange(64))
    win = SimpleNamespace(units=1, window_s=1.0)
    ctx = SimpleNamespace(kind="train", slice=object(), step_ids=tctx.step_ids, graph=g,
                          config=cell.config, ref=ref, win=win)
    assert readers.train_mfu(ctx) > 0 and calls["tower_train_flops"] == 1
    ctx.kind = "eval"
    eval_mfu = harness._load_module(harness.reader_path("metrics", "eval_mfu"))
    assert eval_mfu.read(ctx) > 0 and calls["tower_eval_flops"] == 1


BAD = {"a missing file": ("gnnbench/reference/nope.py", "sage"),
       "a file outside gnnbench/": ("gnnbench/../bench.py", "sage"),
       "another ARCH": ("gnnbench/reference/sage.py", "gat")}


@pytest.mark.parametrize("case", sorted(BAD) + [f"no {n}" for n in harness.INTERFACE])
def test_a_reference_that_cannot_serve_is_refused_before_the_graph(tmp_path, monkeypatch,
                                                                    case):
    root = make_root(tmp_path, limits="loose")
    if case.startswith("no "):
        monkeypatch.setattr(harness, "PKG", root / "gnnbench")
        (root / "gnnbench" / "reference").mkdir()
        (root / "gnnbench" / "reference" / "partial.py").write_text(
            f"from gnnbench.reference.sage import *  # noqa: F401, F403\ndel {case[3:]}\n")
        reference, arch = "gnnbench/reference/partial.py", "sage"
    else:
        reference, arch = BAD[case]
    for path in (root / "gnnbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["reference"] = reference
        cfg["model"]["arch"] = arch
        path.write_text(json.dumps(cfg))
    built = []
    monkeypatch.setattr(harness, "load_graph", lambda *args: built.append(args))
    with pytest.raises(harness.CellError):
        harness.run_cell(root, "sage-tt-tiny.eval", 1, 0.0, False, device="cpu")
    assert built == []

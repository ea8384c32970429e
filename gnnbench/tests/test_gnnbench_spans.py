"""The per-layer metrics read from the program's spans
(``gnnbench/spans.py``): the idle time between steps on a hand-built
slice, an untraced window, tracing on for the slice, the stats of traced
units after it, one switch for all readers, nothing read from a program
without spans, and the readers' None on the CPU cells."""

import json
from types import SimpleNamespace

import pytest
import torch

from gnnbench import harness, spans
from gnnbench.graph import load_graph
from gnnbench.profiling import Slice
from gnnbench.tests.cells import make_root

NEW = ("sample_ms", "lookup_ms.train", "tower_fwd_ms", "backward_ms", "update_ms",
       "idle_between_steps_ms", "lookup_ms.eval", "aggregate_ms")


def reader(name):
    return harness._load_module(harness.reader_path("metrics", name))


def test_idle_between_steps_on_a_hand_built_slice():
    """Device busy 0-10, 12-20, 25-30, 31-40 us (gaps 10-12, 20-25, 30-31);
    steps open 0-11 and 24-35 on the host: outside them lie 11-12 and
    20-24, 5 us over 2 steps."""
    device = [("k", 0.0, 6.0), ("k", 4.0, 10.0), ("k", 12.0, 20.0), ("k", 25.0, 30.0),
              ("k", 31.0, 40.0)]
    host = [("trainer.step", 0.0, 11.0), ("aten::mm", 1.0, 2.0), ("trainer.step", 24.0, 35.0),
            ("trainer.log", 20.0, 23.0)]
    assert spans.device_gaps(device) == [(10.0, 12.0), (20.0, 25.0), (30.0, 31.0)]
    ctx = SimpleNamespace(kind="train", slice=Slice(wall_s=1.0, device=device, host=host))
    assert reader("idle_between_steps_ms").read(ctx) == pytest.approx(5.0 / 1e3 / 2)
    ctx.slice.host = host[1:2]
    assert reader("idle_between_steps_ms").read(ctx) is None  # no step span: a parent program
    ctx.kind = "eval"
    assert reader("idle_between_steps_ms").read(ctx) is None


@pytest.mark.parametrize("gaps,steps,want", [
    ([(0.0, 10.0)], [], 10.0),
    ([(0.0, 10.0)], [(-5.0, 15.0)], 0.0),
    ([(0.0, 10.0), (20.0, 30.0)], [(5.0, 25.0)], 10.0),
    ([(0.0, 10.0)], [(1.0, 2.0), (3.0, 4.0), (9.0, 12.0)], 7.0),
])
def test_outside(gaps, steps, want):
    assert spans.outside(gaps, steps) == pytest.approx(want)


def test_device_ms_a_step_or_a_call():
    window = {"trainer.step": {"calls": 4, "device_ms": 80.0},
              "optim.dense": {"calls": 4, "device_ms": 40.0},
              "sampler.device": {"calls": 4, "device_ms": None},
              "trainer.eval": {"calls": 2, "device_ms": 400.0},
              "embed.lookup": {"calls": 6, "device_ms": 6.0}}
    ctx = SimpleNamespace(kind="train", slice=object(), span_unit=window)
    assert reader("update_ms").read(ctx) == 10.0
    assert reader("lookup_ms.train").read(ctx) == 1.5
    assert reader("sample_ms").read(ctx) is None  # no events
    assert reader("tower_fwd_ms").read(ctx) is None  # no such span
    ctx.kind = "eval"
    assert reader("lookup_ms.eval").read(ctx) == 3.0
    ctx.slice = None
    assert reader("lookup_ms.eval").read(ctx) is None


@pytest.fixture
def tiny_trainer(tmp_path):
    from falcon_ttdforgnns_torch.utils import metrics
    root = make_root(tmp_path, limits="loose")
    cell = harness.load_cell(root, "sage-dense-tiny.train")
    g = load_graph(cell.config["graph"], root / "gnnbench" / "cache")
    weights = cell.ref.make_weights(cell.config, g.num_nodes, g.num_classes, 3, "cpu")
    tr = harness.build_trainer(harness.dataset_of(g, "tiny"), cell.config, cell.traffic, 3,
                               weights, "cpu")
    yield tr
    metrics.set_tracing(False)
    metrics.reset_spans()


def test_one_switch_an_untraced_window_and_traced_units(tiny_trainer, monkeypatch):
    """The window runs untraced; the slice's epoch turns tracing on,
    untimed: span names under the profiler, no record; every reader's
    install shares one switch, and the last undo turns tracing off, removes
    the hook and, after a slice, keeps the stats of traced epochs run for
    at least ``TRACED_S`` seconds."""
    from falcon_ttdforgnns_torch.utils import metrics
    monkeypatch.setattr(spans, "TRACED_S", 0.0)  # one epoch
    tr = tiny_trainer
    ctx = SimpleNamespace(kind="train", slice=None)
    undo = [reader(n).install(tr, ctx) for n in ("sample_ms", "update_ms")]
    assert not metrics.tracing() and "train_epoch" in tr.__dict__
    tr.train_epoch(1)  # the window
    assert not metrics.tracing() and metrics.span_stats() == {}
    ctx.win = SimpleNamespace(units=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_epoch(2)  # the slice
    assert metrics.tracing() and metrics.span_stats() == {}
    steps = sum(e.name == "trainer.step" for e in prof.events())
    assert steps > 0
    undo[0]()
    assert metrics.tracing() and not hasattr(ctx, "span_unit")
    ctx.slice = object()
    undo[1]()
    assert not metrics.tracing() and "train_epoch" not in tr.__dict__
    assert ctx.span_unit["trainer.step"]["calls"] == steps  # one epoch, not the slice's
    assert ctx.span_unit["optim.dense"]["calls"] == steps
    assert metrics.span_stats() == {}


def test_a_program_without_spans(tiny_trainer, monkeypatch):
    monkeypatch.setattr(spans, "_tracer", lambda: None)
    ctx = SimpleNamespace(kind="train", slice=None)
    undo = reader("tower_fwd_ms").install(tiny_trainer, ctx)
    assert "train_epoch" not in tiny_trainer.__dict__
    undo()
    ctx.slice = object()
    assert reader("tower_fwd_ms").read(ctx) is None


@pytest.mark.parametrize("workload", ["sage-dense-tiny.train", "sage-tt-tiny.eval"])
def test_new_readers_read_nothing_on_the_cpu(tmp_path, workload):
    from falcon_ttdforgnns_torch.utils import metrics
    root = make_root(tmp_path, limits="loose")
    out = harness.run_cell(root, workload, 2**31 + 5, 0.0, True, device="cpu")
    assert out["correct"] is True
    assert not set(NEW) & set(out["metrics"])
    assert not metrics.tracing()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mine = {m["name"] for m in bench["per_layer"] if workload in m.get("workloads", [])}
    assert mine & set(NEW)  # the cell lists some of them

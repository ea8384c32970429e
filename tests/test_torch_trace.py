"""The program's spans (``utils/metrics.py`` ``span``, ``count``,
``set_tracing``, ``span_stats``) on tiny trainers on the CPU: off, they
leave no record and no profiler event; on, each layer's span appears inside
the one it belongs to, once a step or call, with the host reads counted;
and tracing changes no number the trainer computes.  The CUDA events are
checked on the card only.  This file imports neither jax nor the JAX
package, so it runs on the card as well:

    python -m pytest tests/test_torch_trace.py -q --noconftest
"""

import dataclasses
import glob
import json
import warnings

import pytest
import torch

from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
from falcon_ttdforgnns_torch.utils import metrics

SPANS = ("trainer.step", "trainer.prep", "trainer.log", "trainer.backward", "sampler.device",
         "embed.lookup", "embed.sort", "tower.fwd", "tower.conv", "optim.dense", "optim.tt",
         "spmm.aggregate", "spmm.rows", "trainer.eval", "trainer.accuracies")
TINY = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2, tt_ranks=(4, 4),
            lr=0.003, seed=0, steps_per_call=2, log_every=4)
PATHS = {  # the configurations of the benchmark's cells, and the fused TT step
    "dense": dict(use_tt=False, mode="puregpu"),
    "tt": dict(mode="puregpu", sparse=True, bf16=True),
    "eval": dict(mode="puregpu", sparse=True, bf16=True),
}
# 300 train ids: groups of 2 x 64 seeds, so 3 groups and 6 steps an epoch
STEPS, GROUPS = 6, 3


@pytest.fixture(autouse=True)
def tracer():
    metrics.set_tracing(False)
    metrics.reset_spans()
    yield
    metrics.set_tracing(False)
    metrics.reset_spans()


@pytest.fixture(scope="module")
def dataset():
    ds = hard_synthetic_dataset(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16,
                                seed=0)
    return dataclasses.replace(ds, train_idx=ds.train_idx[:300])


def trainer(ds, path, device="cpu"):
    return SageTrainer(ds, TrainConfig(**TINY, **PATHS[path]), device=device)


def run(tr, path):
    """One epoch, or one evaluate(); returns what it computed."""
    return tr.evaluate() if path == "eval" else tr.train_epoch(0)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_off_leaves_no_record(dataset, path):
    tr = trainer(dataset, path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(tr, path)
    names = {e.name for e in prof.events()}
    assert not names & set(SPANS)
    assert metrics.span_stats() == {}
    assert metrics.span("x") is metrics.span("y")  # one shared null context


# the host reads a path counts: one log line and the summary read two
# values each; the evaluation reads its accuracies, and the first one the
# checks of the row index it builds
READS = {"dense": {"trainer.host_reads": 4}, "tt": {"trainer.host_reads": 4},
         "eval": {"trainer.host_reads": 1, "spmm.host_reads": 1}}


def test_untimed_tracing_only_names_the_blocks(dataset):
    """Untimed, the spans are names on the profiler's timeline and nothing
    else: no record, no counter, and without a profiler the null context."""
    tr = trainer(dataset, "dense")
    metrics.set_tracing(True, timed=False)
    assert metrics.span("x") is metrics.span("y")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_epoch(0)
    metrics.set_tracing(False)
    names = [e.name for e in prof.events()]
    assert names.count("trainer.step") == STEPS and "optim.dense" in names
    assert metrics.span_stats() == {}


def expected(path):
    """Each span the path runs: (calls, the spans it runs inside)."""
    step = ["trainer.step"]
    if path == "eval":  # two layers: the first in f32, the second in bf16, whose
        # conv narrows (16 -> 4 classes, padded to 8): its product, then its mean
        # and its finish, two tower.conv spans
        return {"trainer.eval": (1, [None]), "embed.lookup": (1, ["trainer.eval"]),
                "spmm.aggregate": (2, ["trainer.eval"]), "spmm.rows": (1, ["trainer.eval"]),
                "tower.conv": (3, ["trainer.eval"]),
                "trainer.accuracies": (1, ["trainer.eval"])}
    out = {"trainer.step": (STEPS, [None]), "trainer.prep": (1 + GROUPS, [None]),
           "trainer.log": (2, [None]), "sampler.device": (STEPS, step),
           "embed.lookup": (STEPS, step), "tower.fwd": (STEPS, step),
           "trainer.backward": (STEPS, step), "optim.dense": (STEPS, step)}
    if path == "tt":
        out.update({"embed.sort": (STEPS, step), "optim.tt": (STEPS, step)})
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_and_count_a_step(dataset, path):
    tr = trainer(dataset, path)
    metrics.set_tracing(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(tr, path)
    metrics.set_tracing(False)
    want = expected(path)
    stats = metrics.span_stats()
    assert {n: stats.pop(n)["count"] for n in READS[path]} == READS[path]
    assert set(stats) == set(want)
    for name, (calls, parents) in want.items():
        s = stats[name]
        assert (s["calls"], s["parents"]) == (calls, parents), name
        # events once CUDA is initialised (on the card, after another test
        # used it), even around a CPU trainer's work; none without a card
        assert (s["device_ms"] is None) == (not torch.cuda.is_initialized()), name
        assert 0 <= s["host_self_ms"] <= s["host_ms"]
    # every span inside a step or call shares its unit: it runs in each one
    top = "trainer.eval" if path == "eval" else "trainer.step"
    assert stats[top]["units"] == (1 if path == "eval" else STEPS)
    for name, s in stats.items():
        if s["parents"] != [None]:
            assert s["units"] == stats[top]["units"], name
    assert want.keys() <= {e.name for e in prof.events()}  # on the profiler's clock too


def state(tr):
    """Every tensor the trainer's steps change: parameters, optimizer state."""
    out = dict(tr.model.named_parameters())
    for k, st in (("adam", tr.opt_state), ("tt", tr.tt_opt)):
        if st is not None:
            out.update({f"{k}.m{i}": t for i, t in enumerate(st.m)})
            out.update({f"{k}.v{i}": t for i, t in enumerate(st.v)})
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_changes_no_number(dataset, path):
    """Losses, gradients (Adam's moments) and parameters after an epoch,
    or an evaluate()'s logits and accuracies, bit for bit with tracing on
    and off."""
    got = []
    for on in (False, True):
        tr = trainer(dataset, path)
        logits = []
        if path == "eval":
            tr.train_epoch(0)
            inner = tr._accuracies
            tr._accuracies = lambda x: logits.append(x) or inner(x)
        metrics.set_tracing(on)
        out = run(tr, path)
        metrics.set_tracing(False)
        for k in ("epoch_time", "samples_per_s"):  # the host's clock
            out.pop(k, None)
        got.append((out, tr._metrics["loss"], logits, state(tr)))
    (a, la, xa, sa), (b, lb, xb, sb) = got
    assert (a, la) == (b, lb)
    assert len(xa) == len(xb) and all(torch.equal(x, y) for x, y in zip(xa, xb))
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_profile_trace_writes_the_span_table(dataset, tmp_path):
    tr = trainer(dataset, "dense")
    with metrics.profile_trace(str(tmp_path)):
        assert metrics.tracing()
        tr.train_epoch(0)
    assert not metrics.tracing()
    (table,) = glob.glob(str(tmp_path / "spans_*.json"))
    (trace,) = glob.glob(str(tmp_path / "trace_*.json"))
    assert table.rsplit("spans_", 1)[1] == trace.rsplit("trace_", 1)[1]
    stats = json.load(open(table))
    assert stats["trainer.step"]["calls"] == STEPS
    assert stats["sampler.device"]["parents"] == ["trainer.step"]
    assert any(e.get("name") == "trainer.step" for e in json.load(open(trace))["traceEvents"])


@pytest.mark.parametrize("capacity,waiting", [(4, ["inner", "inner", "outer"]),
                                               (2, ["outer"])])
def test_self_time_and_the_bounded_buffer(monkeypatch, capacity, waiting):
    """Self time is the total less the direct children's; records wait to
    be resolved until the next outermost span opens or the buffer is full,
    and the totals count every one.  The host's bookkeeping alone: no
    events, whose completion would decide what waits."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    tr = metrics.SpanTracer(capacity=capacity)
    for _ in range(5):
        outer = tr.enter("outer")
        for _ in range(2):
            tr.exit(tr.enter("inner"))
        tr.exit(outer)
    assert [r.name for r in tr.pending] == waiting
    s = tr.stats()
    assert (s["outer"]["calls"], s["inner"]["calls"]) == (5, 10)
    assert (s["outer"]["units"], s["inner"]["units"]) == (5, 5)
    assert s["outer"]["host_self_ms"] == pytest.approx(
        s["outer"]["host_ms"] - s["inner"]["host_ms"])
    assert s["inner"]["host_self_ms"] == s["inner"]["host_ms"]


def test_spanned_draws_each_item_under_the_span():
    metrics.set_tracing(True)
    assert list(metrics.spanned(iter("abc"), "trainer.prep")) == list("abc")
    assert metrics.span_stats()["trainer.prep"]["calls"] == 4  # the last draw ends it


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' events time the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def synced(fn) -> int:
    """The synchronising calls ``fn`` makes, by the sync debug mode."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing" in str(w.message) for w in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "tt"])
def test_span_events_time_the_card(dataset, cuda, path):
    """On the card: device ms for every span, the children's within their
    step's, and no span adds a synchronising call to a step."""
    tr = trainer(dataset, path, device="cuda")
    tr.train_epoch(0)
    seeds = torch.as_tensor(dataset.train_idx[:64], device=cuda)
    labels = torch.as_tensor(dataset.labels[dataset.train_idx[:64]], device=cuda)
    step = lambda: tr.device_train_step(seeds, labels)  # noqa: E731
    off = synced(step)
    metrics.set_tracing(True)
    on = synced(step)
    tr.train_epoch(1)
    metrics.set_tracing(False)
    assert on == off
    stats = metrics.span_stats()
    assert all(s["device_ms"] is not None for n, s in stats.items() if "count" not in s)
    step_ms = stats["trainer.step"]["device_ms"]
    inside = sum(s["device_ms"] for s in stats.values() if s.get("parents") == ["trainer.step"])
    assert 0 < inside <= step_ms
    assert stats["trainer.step"]["device_self_ms"] == pytest.approx(step_ms - inside)

"""Observability helpers: throughput, memory, timing, tracing and access
analytics (port of ``falcon_ttdforgnns_tpu/utils/metrics.py``: parity with
the reference's ``utils.py:21-51`` memory_usage, count_nnz and
give_throughput, ``utils.py:162-194`` access-percentage analytics and
``utils.py:196-220`` gpu_timing).  Timing uses CUDA events and tracing
``torch.profiler``; the plots are drawn only where matplotlib is
installed, as in the reference.

The program's spans (:func:`span`, :func:`count`, :func:`set_tracing`,
:func:`span_stats`, :func:`reset_spans`) time its layers where the work
runs.  Tracing is off by default, and then a span is one shared null
context.  While it is on, a span opens a ``torch.profiler.record_function``
of its name while a profiler records (so that its trace shows the span on
the clock of the device records), reads the host clock at enter and exit
and, once CUDA is initialised, records a pair of CUDA events on the current
stream (none while the stream is being captured).  No span synchronises: a record's
events are resolved once the device has reached them (``query()``, each
time an outermost span opens) or when the stats are read, after a
synchronise.  A span's device ms is the time
between the stream reaching its start event and its end event: its device
work while the host is ahead, and besides that whatever the device waited
inside it for the host while the host is behind."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch


def throughput(num_samples: int, seconds: float) -> float:
    return num_samples / max(seconds, 1e-9)


def edges_per_second(num_edges_processed: int, seconds: float) -> float:
    """The BASELINE.json scaling metric."""
    return num_edges_processed / max(seconds, 1e-9)


def device_timing(fn: Callable, *args, warmup: int = 10, reps: int = 100,
                  device: Optional[torch.device] = None) -> float:
    """Mean ms a call of ``fn(*args)`` on a CUDA device (the reference's
    gpu_timing: 10 warmup calls, then 100 timed), from CUDA events around
    the timed calls on the current stream.  Raises without a CUDA device: a
    host clock would time the CPU's kernels, not the card's."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"device_timing times a CUDA device, not {device}")
    with torch.cuda.device(device):
        for _ in range(1 + warmup):
            fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Allocated and peak device bytes (MB) of each CUDA device, from
    ``torch.cuda.memory_stats``; empty without one (the reference's
    ``th.cuda.max_memory_allocated``, ``sage_dgl_partition.py:112``)."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6}
    return out


class _Record:
    """One span: its name, its parent's record (None at the top), its unit
    (the serial of the outermost span open around it, which every span of
    one step or call shares), the host clock at enter and exit
    (``perf_counter_ns``), its CUDA event pair until it is resolved (None
    where none was recorded), its device ms once resolved, and the host ns
    and device ms its direct children took."""

    __slots__ = ("name", "parent", "unit", "t0", "t1", "stream", "events", "dev",
                 "child_host", "child_dev")

    def __init__(self, name: str, parent: Optional["_Record"], unit: int):
        self.name, self.parent, self.unit = name, parent, unit
        self.t0 = self.t1 = self.child_host = 0
        self.child_dev = 0.0
        self.stream = self.events = self.dev = None


class _Totals:
    __slots__ = ("calls", "units", "last_unit", "host_ns", "host_self_ns", "dev_calls",
                 "dev_ms", "dev_self_ms", "parents")

    def __init__(self):
        self.calls = self.units = self.host_ns = self.host_self_ns = self.dev_calls = 0
        self.last_unit = -1
        self.dev_ms = self.dev_self_ms = 0.0
        self.parents = set()


class SpanTracer:
    """The records of the process's spans: the open ones, innermost last;
    the closed ones whose device time is not known yet, in the order they
    closed (children before their parent), at most ``capacity`` while the
    device keeps up; and the totals by name that every resolved record is
    added to.
    Each time an outermost span opens, the pending records whose end event
    the device has reached (``query()``: no sync) are resolved, their
    events kept for reuse: inside the new span, where a profiler's trace
    shows the cost, and not after the span that last read the device.
    Spans are opened and closed by one thread."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.reset()

    def reset(self) -> None:
        self.open: List[_Record] = []
        self.pending: List[_Record] = []
        self.totals: Dict[str, _Totals] = {}
        self.counters: Dict[str, int] = {}
        self.units = 0
        self.spare: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def enter(self, name: str) -> _Record:
        parent = self.open[-1] if self.open else None
        if parent is None:
            self.units += 1
            self.resolve(wait=False)
        rec = _Record(name, parent, parent.unit if parent else self.units)
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            rec.stream = torch.accelerator.current_stream()  # a fifth of the cuda call's cost
            rec.events = (self.spare.pop() if self.spare else
                          (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            rec.events[0].record(rec.stream)
        self.open.append(rec)
        rec.t0 = time.perf_counter_ns()
        return rec

    def exit(self, rec: _Record) -> None:
        rec.t1 = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record(rec.stream)
        if self.open and self.open[-1] is rec:
            self.open.pop()
        if rec.parent is not None:
            rec.parent.child_host += rec.t1 - rec.t0
        self.pending.append(rec)
        if len(self.pending) >= self.capacity:
            self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        """Add the pending records to the totals, oldest first: those the
        device has finished, or all of them after a synchronise."""
        if wait and any(r.events is not None for r in self.pending):
            torch.cuda.synchronize()
        n = 0
        for rec in self.pending:
            if not wait and rec.events is not None and not rec.events[1].query():
                break
            n += 1
        for rec in self.pending[:n]:
            t = self.totals.get(rec.name)
            if t is None:
                t = self.totals[rec.name] = _Totals()
            t.calls += 1
            if rec.unit != t.last_unit:
                t.units, t.last_unit = t.units + 1, rec.unit
            host = rec.t1 - rec.t0
            t.host_ns += host
            t.host_self_ns += host - rec.child_host
            t.parents.add(rec.parent.name if rec.parent else None)
            if rec.events is not None:
                rec.dev = rec.events[0].elapsed_time(rec.events[1])
                self.spare.append(rec.events)
                rec.stream = rec.events = None
                t.dev_calls += 1
                t.dev_ms += rec.dev
                t.dev_self_ms += rec.dev - rec.child_dev
                if rec.parent is not None:
                    rec.parent.child_dev += rec.dev
        del self.pending[:n]

    def stats(self) -> Dict[str, Dict[str, object]]:
        self.resolve(wait=True)
        out: Dict[str, Dict[str, object]] = {}
        for name, t in self.totals.items():
            dev = t.dev_calls > 0
            out[name] = {"calls": t.calls, "units": t.units,
                         "host_ms": t.host_ns / 1e6, "host_self_ms": t.host_self_ns / 1e6,
                         "device_ms": t.dev_ms if dev else None,
                         "device_self_ms": t.dev_self_ms if dev else None,
                         "parents": sorted(t.parents, key=lambda p: (p is not None, p or ""))}
        out.update({name: {"count": n} for name, n in self.counters.items()})
        return out


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():  # a record only a profiler reads
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _TRACER.enter(self.name)
        return self

    def __exit__(self, *exc):
        _TRACER.exit(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_TRACER = SpanTracer()
_tracing = False
_timed = True
_OFF = contextlib.nullcontext()
_END = object()


def span(name: str):
    """A context manager that times the block as the span ``name`` while
    tracing is on; while it is off, one shared null context.  Untimed, the
    span is only its ``record_function`` under a profiler."""
    if not _tracing:
        return _OFF
    if not _timed:
        return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host-side counter ``name`` while tracing is on and
    timed."""
    if _tracing and _timed:
        _TRACER.counters[name] = _TRACER.counters.get(name, 0) + n


def set_tracing(on: bool, timed: bool = True) -> None:
    """Turn the spans and counters on or off; turning them off keeps what
    they recorded.  With ``timed`` false the spans only name their blocks
    on a profiler's timeline: no clock read, no CUDA event, no record, and
    none of the CUDA calls a profiler would see around the block's own."""
    global _tracing, _timed
    _tracing, _timed = bool(on), bool(timed)


def tracing() -> bool:
    return _tracing


def reset_spans() -> None:
    """Forget every record, total and counter."""
    _TRACER.reset()


def span_stats() -> Dict[str, Dict[str, object]]:
    """By name, each span's ``calls``, ``units`` (the steps or calls it ran
    in), ``host_ms`` and ``host_self_ms``, ``device_ms`` and
    ``device_self_ms`` (None where no CUDA event was recorded) and
    ``parents`` (the names of the spans it ran inside, None at the top);
    each counter's ``count``.  Self is the total less the part of the
    interval that the direct child spans cover.  Synchronises the device
    where a record holds events."""
    return _TRACER.stats()


def spanned(items: Iterable, name: str) -> Iterator:
    """``items``, each drawn under the span ``name`` (a loader's batches)."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, device activity), written as a Chrome trace into ``log_dir``
    (``trace_<pid>_<ns>.json``), with the program's spans on for the block
    and their table (:func:`span_stats`) beside it
    (``spans_<pid>_<ns>.json``); without ``log_dir`` the block runs as it
    is."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = (_tracing, _timed)
    if not (was[0] and was[1]):
        reset_spans()
    set_tracing(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        set_tracing(*was)
    tag = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{tag}.json"))
    with open(os.path.join(log_dir, f"spans_{tag}.json"), "w") as f:
        json.dump(span_stats(), f, indent=1)


def model_size_mb(tensors: Iterable[torch.Tensor]) -> float:
    """Bytes of ``tensors`` (e.g. a module's parameters) in MB (1e6)."""
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


def access_percentages(access_counts, top_fracs: Tuple[float, ...] = (0.01, 0.05, 0.1, 0.2, 0.5)
                       ) -> Dict[float, float]:
    """Share of all accesses served by the top-x hottest rows, for each x of
    ``top_fracs``: the skew that motivates the LFU cache."""
    counts = np.sort(np.asarray(access_counts))[::-1].astype(np.float64)
    total = counts.sum()
    if total == 0:
        return {f: 0.0 for f in top_fracs}
    cum = np.cumsum(counts)
    n = len(counts)
    return {f: float(cum[max(1, int(f * n)) - 1] / total) for f in top_fracs}


def cumulative_access_curve(access_counts, points: int = 100
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(share of rows, share of accesses) at ``points`` shares of the rows,
    hottest first: the access CDF."""
    counts = np.sort(np.asarray(access_counts))[::-1].astype(np.float64)
    cum = np.cumsum(counts) / max(counts.sum(), 1.0)
    xs = np.linspace(0, 1, points)
    idx = np.clip((xs * len(counts)).astype(int), 0, len(counts) - 1)
    return xs, cum[idx]


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is not
    installed (the plots are optional, as in the reference)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_access_cdf(access_counts, path: str) -> bool:
    """The access CDF as a figure at ``path`` (``utils.py:176-194``);
    returns whether a file was written (not without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return False
    xs, ys = cumulative_access_curve(access_counts)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(xs * 100, ys * 100)
    ax.set_xlabel("top % of rows")
    ax.set_ylabel("% of accesses")
    ax.set_title("embedding access skew")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def degree_histogram(degrees, bins: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Log-binned degree distribution (``graphloader.py:188-207``): the bin
    edges and the count of nodes in each."""
    degrees = np.asarray(degrees)
    dmax = max(int(degrees.max()), 1)
    edges = np.unique(np.round(np.logspace(0, np.log10(dmax + 1), bins)).astype(np.int64))
    hist, _ = np.histogram(degrees, bins=edges)
    return edges, hist


def plot_degree_distribution(degrees, path: str) -> bool:
    """The degree histogram on log axes at ``path``; returns whether a file
    was written (not without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return False
    edges, hist = degree_histogram(degrees)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.loglog(edges[:-1] + 1, hist + 1)
    ax.set_xlabel("degree")
    ax.set_ylabel("#nodes")
    ax.set_title("degree distribution")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def count_nnz(indices) -> Dict[str, float]:
    """A batch's ids (``utils.py:21-33`` count_nnz): total ids, distinct ids
    and the duplication factor, what a lookup that deduplicates saves."""
    idx = np.asarray(indices).reshape(-1)
    uniq = np.unique(idx)
    return {"nnz": int(idx.size), "unique": int(uniq.size),
            "dup_factor": float(idx.size / max(uniq.size, 1))}


def max_batch_size(num_nodes: int, feat_dim: int, hidden_dim: int, fanouts,
                   device_bytes: Optional[int] = None, dtype_bytes: int = 4,
                   safety: float = 0.5) -> int:
    """The largest seed batch whose dense-fanout activations fit
    ``safety`` of ``device_bytes`` (``utils.py:45-51``, re-derived for
    this memory model): each seed has sum over levels of prod(fanouts[:l])
    rows of max(feat, hidden) values, twice for the backward.
    ``device_bytes`` defaults to the current CUDA device's memory."""
    if device_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("max_batch_size needs device_bytes without a CUDA device")
        device_bytes = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    per_seed_rows = rows = 1
    for f in reversed(list(fanouts)):
        rows *= f
        per_seed_rows += rows
    bytes_per_seed = per_seed_rows * max(feat_dim, hidden_dim) * dtype_bytes * 2
    return max(1, int(device_bytes * safety / bytes_per_seed))

"""Per-layer metrics from the program's own spans
(``falcon_ttdforgnns_torch.utils.metrics``: ``span``, ``set_tracing``,
``span_stats``), which time each layer where the work runs: CUDA events
on the stream, a ``record_function`` on the profiler's clock.

A traced run's window runs with the program's tracing off, as in an
untraced run, so that the metrics read from the window (the idle share,
the MFU) read the same work as the parent's.  ``install`` turns tracing on,
untimed, as the profiled slice's unit starts: the slice's host records
carry the program's span names, and the spans add no clock read, CUDA
event or record there, so that the slice's kernels and gaps are timed as
the parent's are.  After the slice, the last undo runs units of the
traffic (``train_epoch`` or ``evaluate()`` calls, at least ``TRACED_S``
seconds of them) with tracing on, unprofiled, and keeps their stats
(``span_stats``, after a synchronise) for the readers.  The readers of one
run share one switch, counted on the run's context.  Where the program has
no tracer (a checkout older than its spans), ``install`` does nothing and
the readers return None.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

UNIT = {"train": ("trainer.step", "train_epoch"), "eval": ("trainer.eval", "evaluate")}
TRACED_S = 2.0  # an epoch of the dense cell; ~9 of the eval cell's calls


def _tracer():
    """The program's tracing module, or None where it has none."""
    try:
        from falcon_ttdforgnns_torch.utils import metrics
    except ImportError:
        return None
    return metrics if hasattr(metrics, "span_stats") else None


def _traced_units(trainer, kind: str, m) -> dict:
    """The span stats of units run with tracing on until ``TRACED_S``
    seconds have passed: epoch 0's draws again, or ``evaluate()`` of the
    weights as they are (both end in a read of the device)."""
    m.reset_spans()
    m.set_tracing(True)
    try:
        t0 = time.perf_counter()
        while True:
            if kind == "train":
                trainer.train_epoch(0)
            else:
                trainer.evaluate()
            if time.perf_counter() - t0 >= TRACED_S:
                return m.span_stats()
    finally:
        m.set_tracing(False)
        m.reset_spans()


def install(trainer, ctx):
    """Tracing on, untimed, for the profiled slice; the undo turns it off
    and, after a slice, takes the traced units' stats into
    ``ctx.span_unit``."""
    m = _tracer()
    if m is None or ctx.kind not in UNIT:
        return lambda: None
    method = UNIT[ctx.kind][1]
    if getattr(ctx, "span_users", 0) == 0:
        ctx.span_users = 0
        inner = getattr(trainer, method)

        def unit(*args, **kw):
            if getattr(ctx, "win", None) is not None:  # after the window: the slice
                m.set_tracing(True, timed=False)
            return inner(*args, **kw)

        setattr(trainer, method, unit)
    ctx.span_users += 1

    def undo():
        ctx.span_users -= 1
        if ctx.span_users == 0:
            m.set_tracing(False)
            trainer.__dict__.pop(method, None)
            if getattr(ctx, "slice", None) is not None:
                ctx.span_unit = _traced_units(trainer, ctx.kind, m)
    return undo


def device_ms(ctx, name: str) -> Optional[float]:
    """Device ms a step (train) or an ``evaluate()`` call (eval) under the
    program's span ``name`` in the traced units: its total over the calls of
    ``trainer.step`` or ``trainer.eval``; None without a profiled slice or
    without the span's events."""
    stats = getattr(ctx, "span_unit", None)
    if ctx.slice is None or not stats or ctx.kind not in UNIT:
        return None
    unit, s = stats.get(UNIT[ctx.kind][0]), stats.get(name)
    if not unit or not unit.get("calls") or not s or s.get("device_ms") is None:
        return None
    return s["device_ms"] / unit["calls"]


def device_gaps(device: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    """The intervals between the device's busy intervals (the union of its
    records'), in time order."""
    gaps, end = [], None
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def outside(gaps: List[Tuple[float, float]], spans: List[Tuple[float, float]]) -> float:
    """The length of ``gaps`` that no interval of ``spans`` covers; the
    spans do not overlap one another."""
    spans = sorted(spans)
    total, j = 0.0, 0
    for a, b in gaps:
        total += b - a
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total -= min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total

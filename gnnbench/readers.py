"""What several per-layer metrics read alike; each metric's file in
``metrics/`` names the function it reads by."""

from __future__ import annotations

import torch

from . import flops


def idle_share(ctx):
    """The device's idle share of a unit of the untraced window: 1 - the
    device-busy time of the profiled unit (the union of its device
    records' intervals; the profiler leaves the kernels' durations as they
    are) over the wall time a unit of the untraced window took.  The
    profiled unit's own wall time is stretched by the profiler's host
    overhead; the driver reads that slice's share from ``device.busy_s``
    and ``window_s``."""
    if ctx.slice is None:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_us() / 1e6 / (ctx.win.window_s / ctx.win.units))


def train_mfu(ctx):
    """Model FLOPs of the window's epochs over its seconds and the peak of
    the precision the configuration's matmuls run in.  An epoch's model
    FLOPs are those of n_train / batch steps (every labelled seed once):
    the tower's forward and backward at the sampled levels' sizes (the
    configuration's reference counts them), plus the TT chain's useful
    work at the mean distinct ids and prefix runs of the profiled steps."""
    if ctx.kind != "train" or ctx.slice is None or not ctx.step_ids:
        return None
    g, config, win = ctx.graph, ctx.config, ctx.win
    counts = None
    if config.get("tt") is not None:
        p_last = config["tt"]["p_shapes"][-1]
        per = [flops.id_counts(ids, p_last) for ids in ctx.step_ids]
        counts = {k: sum(c[k] for c in per) / len(per) for k in per[0]}
    step = flops.train_step_flops(config, ctx.ref, g.num_classes, counts)
    epoch = step * g.train_idx.shape[0] / config["model"]["batch_size"]
    peak = flops.PEAK_FLOPS[config["precision"]["peak"]]
    return 100.0 * epoch * win.units / win.window_s / peak


def open_span(trainer, method: str, span: str):
    """Run ``trainer.<method>`` under the profiler span ``span``; returns
    the undo."""
    inner = getattr(trainer, method)

    def spanned(*args, **kw):
        with torch.profiler.record_function(span):
            return inner(*args, **kw)

    setattr(trainer, method, spanned)
    return lambda: trainer.__dict__.pop(method, None)


def span_ms(ctx, span: str):
    """Device milliseconds a step of the kernels launched under ``span``."""
    if ctx.slice is None or span not in ctx.slice.under or not ctx.steps:
        return None
    return ctx.slice.under[span][1] / 1e3 / ctx.steps

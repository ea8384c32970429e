"""The device milliseconds a step of the kernels under the span
"dense_update", which this file opens around trainer._apply_update (the
routed update: Adam over the dense table and the tower)."""

from gnnbench import readers


def install(trainer, ctx):
    return readers.open_span(trainer, "_apply_update", "dense_update")


def read(ctx):
    return readers.span_ms(ctx, "dense_update")

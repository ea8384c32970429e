"""The device milliseconds a step of the kernels under the span
"device_sample", which this file opens around trainer.sample_layers (the
in-step sampler of --mode puregpu); read as ``device_sample_ms`` and
``device_sample_ms.dense``."""

from gnnbench import readers


def install(trainer, ctx):
    return readers.open_span(trainer, "sample_layers", "device_sample")


def read(ctx):
    return readers.span_ms(ctx, "device_sample")

"""The device milliseconds a step under the program's span
trainer.backward (the step's ``torch.autograd.grad``: the tower's backward
and the table's gradient, run on autograd's device thread and timed by
the span's events on the stream), in the traced units that
``gnnbench/spans.py`` runs after the profiled slice."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "trainer.backward")

"""The device milliseconds a step (train) or an evaluate() call (eval)
under the program's span embed.lookup: the embedding's lookup of the
step's ids, or of every node; read as ``lookup_ms.train`` and
``lookup_ms.eval`` (``gnnbench/spans.py``)."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "embed.lookup")

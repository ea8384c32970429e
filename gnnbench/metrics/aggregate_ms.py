"""The device milliseconds an evaluate() call under the program's span
spmm.aggregate: every layer's full-graph mean over the in-edges, the CSR
rows of the bf16 layers included, in the traced units that
``gnnbench/spans.py`` runs after the profiled slice."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "spmm.aggregate")

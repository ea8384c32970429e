"""The device milliseconds an evaluate() call under the program's span
spmm.rows (``ops/segment.py`` ``edges_by_row`` inside the bf16
``spmm_mean``: the sort check, the row counts and their prefix sum), in
the traced units that ``gnnbench/spans.py`` runs after the profiled
slice."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "spmm.rows")

"""The device milliseconds an evaluate() call under the program's span
attn.aggregate: each layer's CSR attention over every in-edge and the
self-loops (``csr_gat_bf16``), summed over the layers, in the traced units
that ``gnnbench/spans.py`` runs after the profiled slice."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "attn.aggregate")

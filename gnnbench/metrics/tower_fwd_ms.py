"""The device milliseconds a step under the program's span tower.fwd
(``SAGE._conv_tower``: the conv tower's forward over the sampled levels),
in the traced units that ``gnnbench/spans.py`` runs after the profiled
slice."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "tower.fwd")

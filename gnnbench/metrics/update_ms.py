"""The device milliseconds a step under the program's span optim.dense
(``SageTrainer._apply_update``, or the fused step's ``adam_update``: Adam
over the dense parameters and, without TT, the table), in the traced
units that ``gnnbench/spans.py`` runs after the profiled slice."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "optim.dense")

"""The device's idle milliseconds a step in the profiled epoch while no
``trainer.step`` span of the program was open on the host: the gaps
between the slice's device records, less the part of them that the
host records of ``trainer.step`` cover, both on the profiler's clock,
over the number of those records (``gnnbench/spans.py``)."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.kind != "train":
        return None
    steps = [(s, e) for n, s, e in sl.host if n == "trainer.step"]
    if not steps:
        return None
    return spans.outside(spans.device_gaps(sl.device), steps) / 1e3 / len(steps)

"""adam_f32's least time over its device time in the profiled epoch: a
step's least time (:func:`bound_s`: 28 bytes for each value of the
trainer's Adam group, ``trainer.opt_params``) times the profiled steps,
over the device time of the records named adam_f32*.  None where no such
record exists (a program without the kernel)."""

from gnnbench import flops


def bound_s(values: int) -> float:
    """One Adam step's least time: p, g, m and v read and p, m and v
    written once, f32 (its ~20 operations a value are far below the
    bytes' time)."""
    return flops.bound_s(28 * values, 0)


def install(trainer, ctx):
    ctx.adam_values = sum(p.numel() for p in trainer.opt_params)
    return lambda: None


def read(ctx):
    if ctx.kind != "train" or ctx.slice is None or not ctx.steps:
        return None
    calls, us = ctx.slice.kernel_us("adam_f32")
    if calls == 0 or us <= 0:
        return None
    return 100.0 * ctx.steps * bound_s(ctx.adam_values) / (us / 1e6)

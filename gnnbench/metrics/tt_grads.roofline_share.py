"""tt_grads' least time over its device time in the profiled slice: the
least time of each step's core gradients (``flops.tt_grads_bound_s``, d_out
in the configuration's compute type) at the profiled steps' ids, over the
device time of the records named tt_grads_kernel."""

from gnnbench import flops


def read(ctx):
    tt = ctx.config.get("tt")
    if tt is None or ctx.slice is None or not ctx.step_ids:
        return None
    calls, us = ctx.slice.kernel_us("tt_grads_kernel")
    if calls == 0:
        return None
    d_bytes = 2 if ctx.config["precision"]["compute"] == "bfloat16" else 4
    per = [flops.tt_grads_bound_s(tt, flops.id_counts(ids, tt["p_shapes"][-1]), d_bytes)
           for ids in ctx.step_ids]
    return 100.0 * calls * (sum(per) / len(per)) / (us / 1e6)

"""segment_mean_bf16's least time over its device time in the profiled
evaluate(): each call's least time (``flops.segment_mean_bound_s``: the
whole graph at the hidden width) over the device time of the records
named segment_mean_*."""

from gnnbench import flops


def read(ctx):
    if ctx.kind != "eval" or ctx.slice is None:
        return None
    calls, us = ctx.slice.kernel_us("segment_mean_")
    if calls == 0:
        return None
    g = ctx.graph
    bound = flops.segment_mean_bound_s(g.num_nodes, g.num_edges, ctx.config["model"]["hidden_dim"])
    return 100.0 * calls * bound / (us / 1e6)

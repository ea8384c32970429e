"""csr_mean_f32's least time over its device time in the profiled
evaluate(): each call's least time (:func:`bound_s`: the whole graph at the
configuration's ``feat_dim``, the one f32 layer of a bf16 evaluate) over
the device time of the records named csr_mean_f32*."""

from gnnbench import flops


def bound_s(num_nodes: int, num_edges: int, dim: int) -> float:
    """The f32 full-graph mean's least time: h read and the mean written
    once (f32), the int64 sources and row pointers and the f32 degrees read
    once; an add per edge and column and a division per row and column."""
    n, e, d = num_nodes, num_edges, dim
    return flops.bound_s(4 * n * d + 4 * n * d + 8 * e + 8 * (n + 1) + 4 * n, e * d + n * d)


def read(ctx):
    if ctx.kind != "eval" or ctx.slice is None:
        return None
    calls, us = ctx.slice.kernel_us("csr_mean_f32")
    if calls == 0:
        return None
    g = ctx.graph
    return 100.0 * calls * bound_s(g.num_nodes, g.num_edges,
                                   ctx.config["model"]["feat_dim"]) / (us / 1e6)

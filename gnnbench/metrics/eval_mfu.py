"""Model FLOPs of the window's evaluate() calls over its seconds and the
peak of the precision the configuration's matmuls run in: the tower over
the whole graph (the configuration's reference counts it) and the lookup
of every row."""

from gnnbench import flops


def read(ctx):
    if ctx.kind != "eval" or ctx.slice is None:
        return None
    g, config, win = ctx.graph, ctx.config, ctx.win
    call = flops.eval_flops(config, ctx.ref, g.num_nodes, g.num_edges, g.num_classes)
    peak = flops.PEAK_FLOPS[config["precision"]["peak"]]
    return 100.0 * call * win.units / win.window_s / peak

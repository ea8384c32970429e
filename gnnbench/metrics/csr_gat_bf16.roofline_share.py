"""csr_gat_bf16's least time over its device time in the profiled
evaluate(): the least time of one evaluate's layers (:func:`bound_s` at
each layer's heads and width: C = hidden_dim, the heads side by side, but
the last layer's C = the classes, the heads averaged) times the evaluates
that the csr_gat_bf16* records make, over those records' device time."""

from gnnbench import flops


def bound_s(num_nodes: int, num_edges: int, heads: int, width: int, mean: bool) -> float:
    """One layer's least time: x (n, D) bf16 read once (D = heads x width),
    the result written once (n D, or n width with the head mean), el and er
    (n heads f32 each), the int64 sources and row pointers read once; a
    multiply-add per edge or self-loop and value of x."""
    n, e, d = num_nodes, num_edges, heads * width
    nbytes = 2 * n * d + 2 * n * (width if mean else d) + 8 * n * heads + 8 * e + 8 * (n + 1)
    return flops.bound_s(nbytes, 2 * (e + n) * d)


def call_bound_s(model: dict, num_nodes: int, num_edges: int, num_classes: int) -> float:
    """The least time of one evaluate's csr_gat_bf16 calls, one a layer."""
    L, H = model["num_layers"], model["num_heads"]
    return sum(bound_s(num_nodes, num_edges, H,
                       model["hidden_dim"] if li < L - 1 else num_classes, li == L - 1)
               for li in range(L))


def read(ctx):
    if ctx.kind != "eval" or ctx.slice is None:
        return None
    calls, us = ctx.slice.kernel_us("csr_gat_bf16")
    model = ctx.config["model"]
    if calls == 0 or "num_heads" not in model:
        return None
    g = ctx.graph
    per_call = call_bound_s(model, g.num_nodes, g.num_edges, g.num_classes)
    return 100.0 * (calls / model["num_layers"]) * per_call / (us / 1e6)

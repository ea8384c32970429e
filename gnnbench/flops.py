"""The yardstick: the H100's peaks, the useful work of a training step and
of a full-graph evaluation counted from shapes, and the least time of the
kernels whose roofline share the benchmark reports.

Work is counted from what the inputs need, never from how a kernel walks
them: the TT chain's multiply-adds at the distinct ids and prefix runs of
a step's ids (the grouped count of ``csrc/tt_kernels.cu``'s note), the
tower's at the sampled tree's level sizes or over the full graph.  So a
roofline reads the same work whatever implements it.  The table's count,
which every architecture shares, is here; the tower's is the
architecture's own, in the configuration's reference module
(``tower_train_flops``, ``tower_eval_flops``).
"""

from __future__ import annotations

from math import prod
from typing import Dict, Sequence

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
# the kernels' roofline: useful operations count against f32 outside the
# tensor cores (no kernel on these paths uses them)
KERNEL_FLOPS = PEAK_FLOPS["float32"]


def bound_s(nbytes: float, flops: float) -> float:
    """The least time: the larger of compulsory bytes over the HBM rate and
    useful operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / KERNEL_FLOPS)


# ---------------------------------------------------------------- TT chain
def tt_strides(p_shapes: Sequence[int]) -> list:
    """Row-major strides: digit k of an id is (id // stride_k) % p_k."""
    return [prod(p_shapes[k + 1:]) for k in range(len(p_shapes))]


def level_macs(q_shapes: Sequence[int], ranks: Sequence[int]) -> tuple:
    """(the last level, the prefix chain P_{T-2}) in multiply-adds:
    L_{T-1} r_{T-1} q_{T-1} and sum_{k=1}^{T-2} L_k r_k q_k r_{k+1}, with
    L_k = q_0 ... q_{k-1} (1,600 and 6,400 at products' q=5,5,4, ranks 16,16)."""
    fr = (1, *ranks, 1)
    T = len(q_shapes)
    L = [prod(q_shapes[:k]) for k in range(T + 1)]
    return (L[T - 1] * fr[T - 1] * q_shapes[T - 1],
            sum(L[k] * fr[k] * q_shapes[k] * fr[k + 1] for k in range(1, T - 1)))


def fwd_macs(q_shapes, ranks, distinct: int, prefix_runs: int) -> int:
    """The lookup's useful multiply-adds: the last level per distinct id,
    the prefix chain per prefix run."""
    last, pre = level_macs(q_shapes, ranks)
    return distinct * last + prefix_runs * pre


def grads_macs(q_shapes, ranks, distinct: int, prefix_runs: int) -> int:
    """The core gradients' useful multiply-adds: twice the last level per
    distinct id (the last core's gradient row and the chain gradient),
    three times the prefix chain per prefix run (recomputed, then the
    backward through cores T-2..1)."""
    last, pre = level_macs(q_shapes, ranks)
    return distinct * 2 * last + prefix_runs * 3 * pre


def id_counts(ids: torch.Tensor, p_last: int) -> Dict[str, int]:
    """What the TT kernels' work depends on: ids, distinct ids, and prefix
    runs (distinct values of id // p_last among them)."""
    u = torch.unique(ids.long())
    return {"ids": int(ids.numel()), "distinct": int(u.numel()),
            "prefix_runs": int(torch.unique(u // p_last).numel())}


def num_tt_params(p_shapes, q_shapes, ranks) -> int:
    fr = (1, *ranks, 1)
    return sum(p * fr[k] * q * fr[k + 1] for k, (p, q) in enumerate(zip(p_shapes, q_shapes)))


def tt_fwd_bound_s(tt: dict, counts: dict, out_bytes: int) -> float:
    """tt_fwd's least time: the ids (4 B) read, the rows written once
    (``out_bytes`` a value), the cores read once; the useful multiply-adds."""
    B, D = counts["ids"], prod(tt["q_shapes"])
    nbytes = 4 * B + out_bytes * B * D + 4 * num_tt_params(tt["p_shapes"], tt["q_shapes"],
                                                         tt["ranks"])
    return bound_s(nbytes, 2 * fwd_macs(tt["q_shapes"], tt["ranks"], counts["distinct"],
                                        counts["prefix_runs"]))


def tt_grads_bound_s(tt: dict, counts: dict, d_bytes: int) -> float:
    """tt_grads' least time: the ids and d_out read once, the cores read and
    the gradient written once; the useful multiply-adds."""
    B, D = counts["ids"], prod(tt["q_shapes"])
    nbytes = 4 * B + d_bytes * B * D + 8 * num_tt_params(tt["p_shapes"], tt["q_shapes"],
                                                       tt["ranks"])
    return bound_s(nbytes, 2 * grads_macs(tt["q_shapes"], tt["ranks"], counts["distinct"],
                                          counts["prefix_runs"]))


def segment_mean_bound_s(num_nodes: int, num_edges: int, dim: int) -> float:
    """The bf16 full-graph mean's least time: h read and the mean written
    once (bf16), the int64 sources and row pointers and the f32 degrees
    read once; an add per edge and column and a division per row and
    column."""
    n, e, d = num_nodes, num_edges, dim
    return bound_s(2 * 2 * n * d + 8 * e + 8 * (n + 1) + 4 * n, e * d + n * d)


# -------------------------------------------------------------- the tower
def level_sizes(batch: int, fanouts: Sequence[int]) -> list:
    """Rows of each level of the sampled tree: the seeds, then each hop
    (``fanouts`` innermost first, as ``--fan-out 5,10,15``)."""
    sizes, n = [batch], batch
    for f in reversed(list(fanouts)):
        n *= f
        sizes.append(n)
    return sizes


def train_step_flops(config: dict, ref, num_classes: int, tt_counts=None) -> float:
    """One step's model FLOPs: the tower's (``ref.tower_train_flops``, the
    configuration's reference module), plus the TT chain's useful forward
    and gradient work at the step's distinct ids and prefix runs
    (``tt_counts``; none for the dense table, whose rows are gathered)."""
    model = config["model"]
    flops = ref.tower_train_flops(model, num_classes, model["feat_dim"])
    tt = config.get("tt")
    if tt is not None and tt_counts is not None:
        q, r = tt["q_shapes"], tt["ranks"]
        flops += 2.0 * (fwd_macs(q, r, tt_counts["distinct"], tt_counts["prefix_runs"])
                        + grads_macs(q, r, tt_counts["distinct"], tt_counts["prefix_runs"]))
    return flops


def eval_flops(config: dict, ref, num_nodes: int, num_edges: int, num_classes: int) -> float:
    """One full-graph evaluation's model FLOPs: the tower's over the whole
    graph (``ref.tower_eval_flops``, the configuration's reference module)
    and the lookup of every row (its distinct ids are all N, its prefix
    runs ceil(N / p_last))."""
    model = config["model"]
    flops = ref.tower_eval_flops(model, num_nodes, num_edges, num_classes, model["feat_dim"])
    tt = config.get("tt")
    if tt is not None:
        runs = -(-num_nodes // tt["p_shapes"][-1])
        flops += 2 * fwd_macs(tt["q_shapes"], tt["ranks"], num_nodes, runs)
    return float(flops)


def median(xs) -> float:
    return float(np.median(np.asarray(xs, dtype=np.float64)))

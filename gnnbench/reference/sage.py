"""The plain reference of the ``sage`` architecture: GraphSAGE (mean
aggregator) over a TT-compressed or dense embedding table, trained by
Adam, and its full-graph layer-wise inference, in plain PyTorch.

A configuration names this file as its ``reference``; the harness reaches
the model only through the names of ``harness.INTERFACE`` here: the
weights, the readings, the logits, the controls, the program's dropout
sites, the masks' shapes and the tower's FLOPs.

It imports nothing of the program and takes nothing the program made:
the weights come from :func:`make_weights` (the benchmark's own draw from
the run's seed), the graph from ``gnnbench/graph.py``.  What it follows
of the program is only the program's randomness, each draw checked by
itself (``gnnbench/check.py``): the sampled fan-out trees and the dropout
masks of the steps it repeats.

``Precision`` says how it computes.  ``REFERENCE`` is float32 throughout,
with TF32 off.  The controls are the same code in the precision below the
one a configuration states: every stored activation and every sum rounded
to float8 e4m3 after each add, and the matmul operands too, for the bf16
flagship; the matmul operands rounded to TF32 (10 mantissa bits) for the
float32 dense baseline.  Rounding is emulated, so the controls read the
same on the CPU and on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from gnnbench.flops import level_sizes

ARCH = "sage"
# the program's modules whose ``dropout`` draws this tower's masks: the
# harness records the masks there, by name (the reference imports nothing
# of the program)
DROPOUT_SITES = ("falcon_ttdforgnns_torch.models.sage",)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at 10 mantissa bits (TF32)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a per-tensor scale (the tensor's largest magnitude
    to 448), back in float32."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


ROUNDERS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tf32": _round_tf32, "fp8": _round_fp8}


class _Round(torch.autograd.Function):
    """Round in the forward and the gradient in the backward."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return ROUNDERS[name](x)

    @staticmethod
    def backward(ctx, g):
        return ROUNDERS[ctx.name](g), None


@dataclass(frozen=True)
class Precision:
    """``store``: the rounding of every stored activation and of every
    partial sum of a mean; ``matmul``: of every matmul operand.  None keeps
    float32."""

    store: Optional[str] = None
    matmul: Optional[str] = None

    def s(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.store is None else _Round.apply(x, self.store)

    def m(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.matmul is None else _Round.apply(x, self.matmul)


REFERENCE = Precision()
CONTROLS = {"fp8": Precision(store="fp8", matmul="fp8"), "tf32": Precision(matmul="tf32")}


# ------------------------------------------------------------- the weights
def tower_dims(model: dict, num_classes: int, feat_dim: int) -> list:
    """(in, out) of each conv."""
    dims = [model["hidden_dim"]] * (model["num_layers"] - 1) + [num_classes]
    return list(zip([feat_dim] + dims[:-1], dims))


def param_shapes(config: dict, num_nodes: int, num_classes: int) -> Dict[str, tuple]:
    """Every trained tensor by the program's parameter name: the TT cores
    (p_k, r_k, q_k, r_{k+1}) or the dense (N, D) table, then each conv's
    self and neighbour weights (out, in) and its bias."""
    model, shapes = config["model"], {}
    tt = config.get("tt")
    if tt is not None:
        fr = (1, *tt["ranks"], 1)
        for k, (p, q) in enumerate(zip(tt["p_shapes"], tt["q_shapes"])):
            shapes[f"embed.tt_core_{k}"] = (p, fr[k], q, fr[k + 1])
    else:
        shapes["embed.weight"] = (num_nodes, model["feat_dim"])
    for li, (i, o) in enumerate(tower_dims(model, num_classes, model["feat_dim"])):
        shapes[f"convs.{li}.lin_self.weight"] = (o, i)
        shapes[f"convs.{li}.lin_self.bias"] = (o,)
        shapes[f"convs.{li}.lin_neigh.weight"] = (o, i)
    return shapes


def make_weights(config: dict, num_nodes: int, num_classes: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The run's weights, drawn on ``device`` from ``seed`` in three calls:
    the TT cores (each N(0, s^2) with s^3 * r_1 * r_2 = 0.1, so a row's
    entries have about the dense table's 0.1 spread), or the dense table
    N(0, 0.1^2); the conv weights N(0, 1/fan_in); the biases
    N(0, 0.01^2)."""
    shapes = param_shapes(config, num_nodes, num_classes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    emb = [n for n in shapes if n.startswith("embed.")]
    tt = config.get("tt")
    sizes = [math.prod(shapes[n]) for n in emb]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = (0.1 / math.prod(tt["ranks"])) ** (1.0 / len(emb)) if tt else 0.1
    for n, piece in zip(emb, torch.split(flat, sizes)):
        out[n] = (piece * scale).reshape(shapes[n])
    del flat
    rest = [n for n in shapes if not n.startswith("embed.")]
    sizes = [math.prod(shapes[n]) for n in rest]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for n, piece in zip(rest, torch.split(flat, sizes)):
        sh = shapes[n]
        out[n] = (piece * (0.01 if len(sh) == 1 else 1.0 / math.sqrt(sh[1]))).reshape(sh)
    return out


# ------------------------------------------------------------- the table
def tt_rows(cores: Sequence[torch.Tensor], ids: torch.Tensor, p_shapes: Sequence[int],
            chunk: int = 1 << 17) -> torch.Tensor:
    """Rows of the TT table: core k gathered at digit k of each id (row
    major over ``p_shapes``), the chain contracted left to right."""
    strides = [math.prod(p_shapes[k + 1:]) for k in range(len(p_shapes))]
    out = []
    for lo in range(0, ids.shape[0], chunk):
        idx = ids[lo:lo + chunk].long()
        g = None
        for k, c in enumerate(cores):
            d = torch.div(idx, strides[k], rounding_mode="floor") % p_shapes[k]
            ck = c.index_select(0, d)  # (n, r, q, r')
            if g is None:
                g = ck.reshape(idx.shape[0], -1, ck.shape[3])  # (n, q0, r1)
            else:
                g = torch.bmm(g, ck.reshape(idx.shape[0], ck.shape[1], -1))
                g = g.reshape(idx.shape[0], -1, ck.shape[3])
        out.append(g.reshape(idx.shape[0], -1))
    return torch.cat(out)


def table_rows(params: Dict[str, torch.Tensor], config: dict, ids: torch.Tensor) -> torch.Tensor:
    tt = config.get("tt")
    if tt is None:
        return params["embed.weight"].index_select(0, ids.long())
    cores = [params[f"embed.tt_core_{k}"] for k in range(len(tt["p_shapes"]))]
    return tt_rows(cores, ids, tt["p_shapes"])


def table_grads(params: Dict[str, torch.Tensor], config: dict, ids: torch.Tensor,
                d_rows: torch.Tensor, chunk: int = 1 << 17) -> Dict[str, torch.Tensor]:
    """The table's gradient from the rows' gradient, chunk by chunk."""
    names = [n for n in params if n.startswith("embed.")]
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    grads = {n: torch.zeros_like(params[n]) for n in names}
    for lo in range(0, ids.shape[0], chunk):
        with torch.enable_grad():
            rows = table_rows(leaves, config, ids[lo:lo + chunk])
            got = torch.autograd.grad(rows, [leaves[n] for n in names], d_rows[lo:lo + chunk])
        for n, g in zip(names, got):
            grads[n] += g
    return grads


# ------------------------------------------------------------- the tower
def rounded_mean(nb: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Mean over dim 2 of (B, n, f, D): in float32, or with every partial
    sum rounded (``prec.store``) and the quotient rounded."""
    if prec.store is None:
        return nb.mean(dim=2)
    acc = nb[:, :, 0]
    for j in range(1, nb.shape[2]):
        acc = prec.s(acc + nb[:, :, j])
    return prec.s(acc / nb.shape[2])


def conv(params: Dict[str, torch.Tensor], li: int, h_dst: torch.Tensor,
         h_neigh: torch.Tensor, prec: Precision) -> torch.Tensor:
    """h_dst W_self^T + b + h_neigh W_neigh^T."""
    ws = params[f"convs.{li}.lin_self.weight"]
    wn = params[f"convs.{li}.lin_neigh.weight"]
    y = prec.s(prec.m(h_dst) @ prec.m(ws).t()) + params[f"convs.{li}.lin_self.bias"]
    return prec.s(prec.s(y) + prec.s(prec.m(h_neigh) @ prec.m(wn).t()))


def tower(params: Dict[str, torch.Tensor], num_layers: int, hs: List[torch.Tensor],
          masks: Sequence[torch.Tensor], prec: Precision) -> torch.Tensor:
    """The sampled tower: conv l over levels 0 .. L-1-l, each level's
    neighbour mean over its children, ReLU and dropout (the recorded keep
    masks, kept values times 2) after every conv but the last."""
    B, keep_scale, it = hs[0].shape[0], 2.0, iter(masks)
    for li in range(num_layers):
        new = []
        for lev in range(len(hs) - 1):
            n = hs[lev].shape[1]
            nb = hs[lev + 1].reshape(B, n, hs[lev + 1].shape[1] // n, -1)
            h = conv(params, li, hs[lev], rounded_mean(nb, prec), prec)
            if li < num_layers - 1:
                mask = next(it)
                if mask.shape != h.shape:
                    raise ValueError(f"dropout mask {tuple(mask.shape)} for an activation "
                                     f"{tuple(h.shape)}")
                h = prec.s(torch.where(mask, torch.relu(h) * keep_scale,
                                       torch.zeros((), device=h.device)))
            new.append(h)
        hs = new
    return hs[0][:, 0, :].float()


def mask_shapes(model: dict, B: int, widths: Sequence[int]) -> List[tuple]:
    """The dropout masks of a step, in the order the program draws them:
    one after every conv but the last, on each level it computes, (B, the
    level's width, hidden)."""
    L, H = model["num_layers"], model["hidden_dim"]
    return [(B, widths[lev], H) for li in range(L - 1) for lev in range(L - li)]


def level_ids(seeds: torch.Tensor, layers: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ids of every level, seeds first, each level row-major."""
    B = seeds.shape[0]
    return torch.cat([seeds.reshape(-1)] + [l.reshape(B, -1).reshape(-1) for l in layers])


def step_loss_and_grads(params, config: dict, seeds, layers, labels, masks, prec: Precision):
    """One step's mean cross-entropy and the gradient of every parameter."""
    model = config["model"]
    B, D = seeds.shape[0], model["feat_dim"]
    ids = level_ids(seeds, layers)
    with torch.no_grad():
        rows = prec.s(table_rows(params, config, ids))
    rows.requires_grad_(True)
    tower_names = [n for n in params if not n.startswith("embed.")]
    leaves = {n: params[n].detach().requires_grad_(True) for n in tower_names}
    with torch.enable_grad():
        hs, off = [], 0
        for width in [1] + [l.reshape(B, -1).shape[1] for l in layers]:
            hs.append(rows[off:off + width * B].reshape(B, width, D))
            off += width * B
        logits = tower(leaves, model["num_layers"], hs, masks, prec)
        loss = F.cross_entropy(logits, labels.long())
        got = torch.autograd.grad(loss, [rows] + [leaves[n] for n in tower_names])
    grads = dict(zip(tower_names, got[1:]))
    grads.update(table_grads(params, config, ids, got[0]))
    return float(loss.detach()), {n: grads[n] for n in params}


@torch.no_grad()
def adam_step(params, grads, state, t: int, lr: float) -> None:
    """optax.adam, in place: bias-corrected moments, eps outside the root."""
    bc1, bc2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    for n, p in params.items():
        g = grads[n]
        m, v = state.setdefault(n, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
        v.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * g * g)
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))


def train_readings(config: dict, weights: Dict[str, torch.Tensor], steps: Sequence[dict],
                   prec: Precision = REFERENCE) -> dict:
    """Repeat the program's first steps from the same weights: each step's
    loss, the first step's gradient and its norm per parameter, and each
    parameter's change after the last step.  ``steps`` holds each step's
    seeds, layers, labels and dropout masks."""
    lr = config["trainer"]["lr"]
    params = {n: w.clone() for n, w in weights.items()}
    state: dict = {}
    losses, grad_norms, first = [], None, None
    for t, st in enumerate(steps, start=1):
        loss, grads = step_loss_and_grads(params, config, st["seeds"], st["layers"],
                                          st["labels"], st["masks"], prec)
        losses.append(loss)
        if t == 1:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            first = grads
        adam_step(params, grads, state, t, lr)
        del grads
    change = {n: float((params[n] - weights[n]).norm()) for n in params}
    return {"losses": losses, "grad_norms": grad_norms, "grads": first, "change_norms": change}


# ------------------------------------------------------ full-graph inference
def rounded_segment_mean(h: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
                         deg: torch.Tensor, prec: Precision, edge_chunk: int) -> torch.Tensor:
    """Each row's mean over its in-neighbours (none: 0): summed in float32
    over chunks of edges, or, with ``prec.store``, in each row's edge order
    with every partial sum rounded."""
    n, D = h.shape[0], h.shape[1]
    if prec.store is None:
        out = torch.zeros((n, D), dtype=torch.float32, device=h.device)
        rows = torch.repeat_interleave(torch.arange(n, device=h.device), deg.long())
        for lo in range(0, indices.shape[0], edge_chunk):
            out.index_add_(0, rows[lo:lo + edge_chunk],
                           h.index_select(0, indices[lo:lo + edge_chunk].long()).float())
        return out / torch.clamp(deg.float(), min=1.0)[:, None]
    acc = torch.zeros((n, D), dtype=torch.float32, device=h.device)
    start, d = indptr[:-1], deg.long()
    for j in range(int(d.max()) if n else 0):
        live = torch.nonzero(d > j).squeeze(1)
        acc[live] = prec.s(acc[live] + h.index_select(0, indices[start[live] + j].long()))
    return prec.s(acc / torch.clamp(deg.float(), min=1.0)[:, None])


@torch.no_grad()
def full_graph_logits(config: dict, params: Dict[str, torch.Tensor], indptr: torch.Tensor,
                      indices: torch.Tensor, prec: Precision = REFERENCE,
                      row_chunk: int = 1 << 17, edge_chunk: int = 1 << 22) -> torch.Tensor:
    """Every node's logits: the table's rows, then each conv over the full
    graph (the mean over every in-edge), ReLU between convs, no dropout."""
    n, L = indptr.shape[0] - 1, config["model"]["num_layers"]
    deg = (indptr[1:] - indptr[:-1])
    h = torch.cat([prec.s(table_rows(params, config, torch.arange(
        lo, min(lo + row_chunk, n), device=indptr.device))) for lo in range(0, n, row_chunk)])
    for li in range(L):
        agg = rounded_segment_mean(h, indptr, indices, deg, prec, edge_chunk)
        h = conv(params, li, h, agg, prec)
        if li < L - 1:
            h = torch.relu(h)
    return h.float()


# ------------------------------------------------------------- the work
def tower_train_flops(model: dict, num_classes: int, feat_dim: int) -> float:
    """A training step's tower matmuls, forward and backward: conv l runs
    on levels 0 .. L-1-l, two products (self and neighbour mean) of
    (rows, in) x (in, out) each; the backward costs twice the forward (the
    input gradient, which layer 0's leaf embedding rows need too, and the
    weight gradient)."""
    sizes = level_sizes(model["batch_size"], model["fanouts"])
    L = model["num_layers"]
    fwd = sum(2 * 2 * sum(sizes[:L - li]) * i * o
              for li, (i, o) in enumerate(tower_dims(model, num_classes, feat_dim)))
    return 3.0 * fwd


def tower_eval_flops(model: dict, num_nodes: int, num_edges: int, num_classes: int,
                     feat_dim: int) -> int:
    """A full-graph evaluation's tower: every conv over all rows, two
    products each.  The means' adds over ``num_edges`` are the SpMM's work,
    which its roofline counts, so SAGE counts none here."""
    return sum(2 * 2 * num_nodes * i * o for i, o in tower_dims(model, num_classes, feat_dim))

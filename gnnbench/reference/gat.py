"""The plain reference of the ``gat`` architecture: GAT with neighbour
sampling (Velickovic et al., "Graph Attention Networks", ICLR 2018), as
OGB's ogbn-products entry "GAT (NeighborSampling)" runs it (PyTorch
Geometric's ``examples/ogbn_products_gat.py``), over a TT-compressed
embedding table, trained by Adam, and its full-graph layer-wise
inference, in plain float32 PyTorch with TF32 off.

Layer l of L maps h to

    x = h W^T                          W (H C, in), no bias, shared by source and target
    el = <x, a_src>, er = <x, a_dst>   per head
    s_uv = leaky_relu(el[u] + er[v], 0.2)
    alpha = softmax of s over v's in-edges and its self-loop
    out_v = concat_h (or, on the last layer, mean_h) sum_u alpha_uv x_u + b + skip(h_v)
    h' = dropout(elu(out), p)          not after the last layer

``skip`` a linear map with bias.  The self-loop is an explicit edge here:
in training the destination slot's own row beside its f sampled slots, in
inference the edge (v, v) appended to v's in-edges.

Where it departs from PyG's example: the 100 feature columns are the
products TT table's rows (p = 125,140,140, q = 5,5,4, ranks 16,16), which
train with the tower; the sampled slots are the program's draws, with
replacement, duplicates included (PyG samples without); the loss is the
mean cross-entropy of the logits (PyG's log_softmax and nll_loss, the same
function); and the precisions below round where the program stores.

A configuration names this file as its ``reference``; the harness reaches
the model only through the names of ``harness.INTERFACE`` here.  It imports
nothing of the program: the TT table, Adam, the roundings and the level
ids are ``reference/sage.py``'s, which this architecture shares.

``Precision`` (``reference/sage.py``) says how it computes: float32
throughout, or the control ``fp8``, the same code with every stored value
rounded to float8 e4m3 (the projections x, each layer's attention result,
its skip with both biases and the sum after it, its activation) and the matmul operands
too, the precision below the configuration's bf16.  el, er, the scores, the
softmax and the weighted sums run in float32 in both, as in the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from gnnbench.flops import level_sizes
# ADAM_B1 and level_ids serve the harness as they are (harness.INTERFACE)
from gnnbench.reference.sage import (ADAM_B1, REFERENCE, Precision, adam_step,  # noqa: F401
                                     level_ids, table_grads, table_rows)

ARCH = "gat"
# the program's module whose ``dropout`` draws this tower's masks
DROPOUT_SITES = ("falcon_ttdforgnns_torch.models.gat_ns",)
CONTROLS = {"fp8": Precision(store="fp8", matmul="fp8")}
NEGATIVE_SLOPE = 0.2


# ------------------------------------------------------------- the weights
def heads_of(config: dict) -> int:
    """The heads the model block states, which the program's ``trainer``
    block must repeat (it reaches the program's TrainConfig alone)."""
    heads = config["model"]["num_heads"]
    if config.get("trainer", {}).get("num_heads", heads) != heads:
        raise ValueError(f"the model block's {heads} heads differ from the trainer block's "
                         f"{config['trainer']['num_heads']}")
    return heads


def tower_dims(model: dict, num_classes: int, feat_dim: int) -> list:
    """(in, C, concat) of each layer: C a head's width, the heads
    concatenated but on the last layer."""
    L, H, hid = model["num_layers"], model["num_heads"], model["hidden_dim"]
    ins = [feat_dim] + [H * hid] * (L - 1)
    return [(i, hid if li < L - 1 else num_classes, li < L - 1) for li, i in enumerate(ins)]


def param_shapes(config: dict, num_nodes: int, num_classes: int) -> Dict[str, tuple]:
    """Every trained tensor by the program's parameter name: the TT cores
    or the dense table, then each layer's projection (H C, in), attention
    vectors (H, C), bias, and skip weight (out, in) and bias."""
    model, shapes = config["model"], {}
    H = heads_of(config)
    tt = config.get("tt")
    if tt is not None:
        fr = (1, *tt["ranks"], 1)
        for k, (p, q) in enumerate(zip(tt["p_shapes"], tt["q_shapes"])):
            shapes[f"embed.tt_core_{k}"] = (p, fr[k], q, fr[k + 1])
    else:
        shapes["embed.weight"] = (num_nodes, model["feat_dim"])
    for li, (i, c, concat) in enumerate(tower_dims(model, num_classes, model["feat_dim"])):
        out = H * c if concat else c
        shapes[f"convs.{li}.fc.weight"] = (H * c, i)
        shapes[f"convs.{li}.att_src"] = (H, c)
        shapes[f"convs.{li}.att_dst"] = (H, c)
        shapes[f"convs.{li}.bias"] = (out,)
        shapes[f"convs.{li}.skip.weight"] = (out, i)
        shapes[f"convs.{li}.skip.bias"] = (out,)
    return shapes


def make_weights(config: dict, num_nodes: int, num_classes: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The run's weights, drawn on ``device`` from ``seed`` in two calls:
    the TT cores as ``reference/sage.py`` draws them (a row's entries about
    N(0, 0.1^2)), or the dense table N(0, 0.1^2); then the projections and
    skips N(0, 1/fan_in), the attention vectors N(0, 1), so that the scores
    spread by about one at such rows and the softmax weighs its edges
    unevenly, and the biases N(0, 0.01^2)."""
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
        std = (1.0 if ".att_" in n else 0.01 if len(sh) == 1 else 1.0 / math.sqrt(sh[1]))
        out[n] = (piece * std).reshape(sh)
    return out


# ------------------------------------------------------------- one layer
def project(params, li: int, h: torch.Tensor, H: int, prec: Precision):
    """x (..., H, C), stored; el and er (..., H) in float32."""
    w = params[f"convs.{li}.fc.weight"]
    x = prec.s(prec.m(h) @ prec.m(w).t())
    x = x.reshape(*x.shape[:-1], H, -1)
    el = (x * prec.m(params[f"convs.{li}.att_src"])).sum(-1)
    er = (x * prec.m(params[f"convs.{li}.att_dst"])).sum(-1)
    return x, el, er


def finish(params, li: int, agg: torch.Tensor, h: torch.Tensor, prec: Precision):
    """The skip with the skip's and the layer's biases, stored, plus the
    attention result, stored."""
    skip = prec.s(prec.m(h) @ prec.m(params[f"convs.{li}.skip.weight"]).t()
                  + (params[f"convs.{li}.skip.bias"] + params[f"convs.{li}.bias"]))
    return prec.s(skip + agg)


def heads_out(out: torch.Tensor, concat: bool, prec: Precision) -> torch.Tensor:
    """(..., H, C) -> the heads side by side, or their mean; stored."""
    return prec.s(out.reshape(*out.shape[:-2], -1) if concat else out.mean(-2))


# ------------------------------------------------------------- the tower
def tower(params: Dict[str, torch.Tensor], model: dict, num_classes: int,
          hs: List[torch.Tensor], masks: Sequence[torch.Tensor], prec: Precision) -> torch.Tensor:
    """The sampled tower: layer l over levels 0 .. L-1-l, each destination
    slot's softmax over its own slot (first) and its f children in the
    next level; ELU and dropout (the recorded keep masks, kept values over
    1 - p) after every layer but the last."""
    L, H = model["num_layers"], model["num_heads"]
    B, keep_scale, it = hs[0].shape[0], 1.0 / (1.0 - model["dropout"]), iter(masks)
    for li, (_, _, concat) in enumerate(tower_dims(model, num_classes, hs[0].shape[-1])):
        proj = [project(params, li, h, H, prec) for h in hs]
        new = []
        for lev in range(len(hs) - 1):
            (x, el, er), (xn, eln, _) = proj[lev], proj[lev + 1]
            n = x.shape[1]
            f = xn.shape[1] // n
            xs = torch.cat([x[:, :, None], xn.reshape(B, n, f, H, -1)], dim=2)
            s = torch.cat([el[:, :, None], eln.reshape(B, n, f, H)], dim=2) + er[:, :, None]
            alpha = torch.softmax(F.leaky_relu(s, NEGATIVE_SLOPE), dim=2)
            agg = heads_out((alpha[..., None] * xs).sum(2), concat, prec)
            h = finish(params, li, agg, hs[lev], prec)
            if li < L - 1:
                mask = next(it)
                if mask.shape != h.shape:
                    raise ValueError(f"dropout mask {tuple(mask.shape)} for an activation "
                                     f"{tuple(h.shape)}")
                h = prec.s(torch.where(mask, F.elu(h) * keep_scale,
                                       torch.zeros((), device=h.device)))
            new.append(h)
        hs = new
    return hs[0][:, 0, :].float()


def mask_shapes(model: dict, B: int, widths: Sequence[int]) -> List[tuple]:
    """The dropout masks of a step, in the order the program draws them:
    one after every layer but the last, on each level it computes, (B, the
    level's width, H * hidden)."""
    L, D = model["num_layers"], model["num_heads"] * model["hidden_dim"]
    return [(B, widths[lev], D) for li in range(L - 1) for lev in range(L - li)]


def step_loss_and_grads(params, config: dict, num_classes: int, seeds, layers, labels, masks,
                        prec: Precision):
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
        logits = tower(leaves, model, num_classes, hs, masks, prec)
        loss = F.cross_entropy(logits, labels.long())
        got = torch.autograd.grad(loss, [rows] + [leaves[n] for n in tower_names])
    grads = dict(zip(tower_names, got[1:]))
    grads.update(table_grads(params, config, ids, got[0]))
    return float(loss.detach()), {n: grads[n] for n in params}


def train_readings(config: dict, weights: Dict[str, torch.Tensor], steps: Sequence[dict],
                   prec: Precision = REFERENCE) -> dict:
    """Repeat the program's first steps from the same weights: each step's
    loss, the first step's gradient and its norm per parameter, and each
    parameter's change after the last step.  ``steps`` holds each step's
    seeds, layers, labels and dropout masks."""
    heads_of(config)
    lr = config["trainer"]["lr"]
    num_classes = weights[f"convs.{config['model']['num_layers'] - 1}.bias"].shape[0]
    params = {n: w.clone() for n, w in weights.items()}
    state: dict = {}
    losses, grad_norms, first = [], None, None
    for t, st in enumerate(steps, start=1):
        loss, grads = step_loss_and_grads(params, config, num_classes, st["seeds"],
                                          st["layers"], st["labels"], st["masks"], prec)
        losses.append(loss)
        if t == 1:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            first = grads
        adam_step(params, grads, state, t, lr)
        del grads
    change = {n: float((params[n] - weights[n]).norm()) for n in params}
    return {"losses": losses, "grad_norms": grad_norms, "grads": first, "change_norms": change}


# ------------------------------------------------------ full-graph inference
def attend_rows(x: torch.Tensor, el: torch.Tensor, er: torch.Tensor, indptr: torch.Tensor,
                indices: torch.Tensor, edge_chunk: int) -> torch.Tensor:
    """Each row's attention over its in-edges and its self-loop, appended
    as the edge (v, v): (N, H, C) in float32, over blocks of whole rows of
    about ``edge_chunk`` edges each."""
    n, H, C = indptr.shape[0] - 1, x.shape[1], x.shape[2]
    out = torch.empty((n, H, C), dtype=torch.float32, device=x.device)
    ptr = indptr.cpu()
    cuts = torch.searchsorted(ptr, torch.arange(0, int(ptr[-1]), edge_chunk))
    cuts = sorted({0, n, *cuts.clamp(max=n).tolist()})
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        e0, e1 = int(ptr[lo]), int(ptr[hi])
        own = torch.arange(lo, hi, device=x.device)
        src = torch.cat([indices[e0:e1].long(), own])
        dst = torch.cat([torch.repeat_interleave(own, indptr[lo + 1:hi + 1] - indptr[lo:hi]),
                         own]) - lo
        s = F.leaky_relu(el.index_select(0, src) + er.index_select(0, dst + lo), NEGATIVE_SLOPE)
        idx = dst[:, None].expand(-1, H)
        m = torch.full((hi - lo, H), -math.inf, device=x.device).scatter_reduce(
            0, idx, s, reduce="amax")
        p = torch.exp(s - m.index_select(0, dst))
        den = torch.zeros((hi - lo, H), device=x.device).index_add_(0, dst, p)
        acc = torch.zeros((hi - lo, H, C), device=x.device)
        acc.index_add_(0, dst, p[:, :, None] * x.index_select(0, src))
        out[lo:hi] = acc / den[:, :, None]
    return out


@torch.no_grad()
def full_graph_logits(config: dict, params: Dict[str, torch.Tensor], indptr: torch.Tensor,
                      indices: torch.Tensor, prec: Precision = REFERENCE,
                      row_chunk: int = 1 << 17, edge_chunk: int = 1 << 19) -> torch.Tensor:
    """Every node's logits: the table's rows, then each layer over the full
    graph (every in-edge and the self-loop), ELU between layers, no
    dropout."""
    model = config["model"]
    n, L, H = indptr.shape[0] - 1, model["num_layers"], heads_of(config)
    h = torch.cat([prec.s(table_rows(params, config, torch.arange(
        lo, min(lo + row_chunk, n), device=indptr.device))) for lo in range(0, n, row_chunk)])
    num_classes = params[f"convs.{L - 1}.bias"].shape[0]
    for li, (_, _, concat) in enumerate(tower_dims(model, num_classes, h.shape[1])):
        x, el, er = project(params, li, h, H, prec)
        agg = heads_out(attend_rows(x, el, er, indptr, indices, edge_chunk), concat, prec)
        del x, el, er
        h = finish(params, li, agg, h, prec)
        del agg
        if li < L - 1:
            h = prec.s(F.elu(h))
    return h.float()


# ------------------------------------------------------------- the work
def tower_train_flops(model: dict, num_classes: int, feat_dim: int) -> float:
    """A training step's tower, forward and backward: layer l projects
    every level of its input, levels 0 .. L-l (2 rows x in x H C), takes
    the skip of its destination levels 0 .. L-1-l (2 rows x in x out) and
    each destination slot's weighted sum over its f children and itself
    (2 (children + rows) x H C); the backward costs twice the forward.
    el, er, the scores and the softmax, a few operations per row and edge,
    are left out."""
    sizes = level_sizes(model["batch_size"], model["fanouts"])
    L, H = model["num_layers"], model["num_heads"]
    fwd = 0
    for li, (i, c, concat) in enumerate(tower_dims(model, num_classes, feat_dim)):
        out = H * c if concat else c
        dst, edges = sum(sizes[:L - li]), sum(sizes[1:L - li + 1])
        fwd += 2 * (dst + sizes[L - li]) * i * H * c + 2 * dst * i * out
        fwd += 2 * (edges + dst) * H * c
    return 3.0 * fwd


def tower_eval_flops(model: dict, num_nodes: int, num_edges: int, num_classes: int,
                     feat_dim: int) -> int:
    """A full-graph evaluation's tower: each layer's projection and skip of
    every row (2 n in H C and 2 n in out) and its weighted sums over every
    in-edge and self-loop (2 (E + n) H C); el, er and the softmax left
    out."""
    n, E, H = num_nodes, num_edges, model["num_heads"]
    total = 0
    for i, c, concat in tower_dims(model, num_classes, feat_dim):
        out = H * c if concat else c
        total += 2 * n * i * H * c + 2 * n * i * out + 2 * (E + n) * H * c
    return total

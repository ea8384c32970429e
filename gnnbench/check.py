"""The comparison that decides ``correct``: the numbers that hold the
program's readings against the plain reference's, and the checks of the
program's own randomness that the reference follows (the sampled trees).

Each number is a gap and is compared against its limit in
``gnnbench/limits/<workload>.json``; PERF.md gives the readings each limit
was set from.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam: its change is not compared
STILL_LEAF = 1e-3


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(abs(r), floor, 1e-30)


def leaf_gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gap of first-step gradient norms (``grad``) and of the
    change after the last step (``change``, only the leaves the
    reference's gradient moves), each over the larger of the reference's
    norm of that leaf and of the median leaf."""
    names = sorted(ref["grad_norms"])
    if sorted(prog["grad_norms"]) != names or sorted(prog["change_norms"]) != names:
        raise ValueError(f"the program's leaves {sorted(prog['grad_norms'])} are not the "
                         f"reference's {names}")
    g_med = float(np.median([ref["grad_norms"][n] for n in names]))
    moved = [n for n in names if ref["grad_norms"][n] >= STILL_LEAF * g_med]
    c_med = float(np.median([ref["change_norms"][n] for n in moved]))
    return {
        "grad": {n: _gap(prog["grad_norms"][n], ref["grad_norms"][n], g_med) for n in names},
        "change": {n: _gap(prog["change_norms"][n], ref["change_norms"][n], c_med)
                   for n in moved},
    }


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the worst step's |loss - reference| over the
    reference's, ``first_loss_gap`` the first step's, which no update has
    touched yet; ``grad_gap`` and ``change_gap``: the worst leaf's of
    :func:`leaf_gaps`; ``grad_diff``: the worst leaf's norm of the
    difference of first-step gradients, over the larger of the reference's
    norm of that leaf and of the median leaf.  A gap of norms sees only the
    part of an error along the gradient, which rounding mostly is not; the
    difference sees all of it."""
    losses = [_gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    leaves = leaf_gaps(prog, ref)
    g_med = float(np.median(list(ref["grad_norms"].values())))
    diff = {n: float((prog["grads"][n].to(g.device).float() - g).norm())
            / max(ref["grad_norms"][n], g_med, 1e-30) for n, g in ref["grads"].items()}
    return {
        "loss_gap": max(losses),
        "first_loss_gap": losses[0],
        "grad_gap": max(leaves["grad"].values()),
        "grad_diff": max(diff.values()),
        "change_gap": max(leaves["change"].values()),
    }


def accuracies(logits: torch.Tensor, labels: torch.Tensor, splits: Sequence[torch.Tensor]):
    pred = logits.argmax(-1)
    return [float((pred[s] == labels[s]).float().mean()) for s in splits]


def eval_numbers(prog_logits: torch.Tensor, prog_accs: Sequence[float],
                 ref_logits: torch.Tensor, labels: torch.Tensor,
                 splits: Sequence[torch.Tensor]) -> Dict[str, float]:
    """``logit_gap``: ||program - reference|| over ||reference|| over every
    node's logits; ``row_gap``: the worst node's gap over the reference's
    root-mean-square row norm; ``acc_gap``: the worst split's |the
    program's accuracy - the reference logits' accuracy|."""
    p, r = prog_logits.float(), ref_logits.float()
    diff = (p - r).norm(dim=1)
    rms = r.norm(dim=1).pow(2).mean().sqrt()
    ref_accs = accuracies(r, labels, splits)
    return {
        "logit_gap": float(diff.norm() / r.norm()),
        "row_gap": float(diff.max() / rms),
        "acc_gap": max(abs(a - b) for a, b in zip(prog_accs, ref_accs, strict=True)),
    }


def in_rows(indptr: torch.Tensor, indices: torch.Tensor, rows: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """Whether each ``vals[i]`` is among the sources of row ``rows[i]``: a
    binary search within the row, whose sources are ascending.  Works on
    the CSR as it is: nothing is built per edge."""
    lo, hi = indptr[rows], indptr[rows + 1]
    end = hi.clone()
    for _ in range(max(int((hi - lo).max()), 1).bit_length()):
        mid = (lo + hi) // 2
        less = (indices[mid.clamp(max=indices.numel() - 1)] < vals) & (lo < hi)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return (lo < end) & (indices[lo.clamp(max=indices.numel() - 1)] == vals)


def tree_faults(indptr: torch.Tensor, indices: torch.Tensor, fanouts: Sequence[int],
                steps: List[dict], train_mask: torch.Tensor, labels: torch.Tensor) -> int:
    """Count what is wrong in the program's recorded steps: a sampled child
    that is no in-neighbour of its parent (an isolated parent samples
    itself), a level of the wrong width, a seed outside the train split or
    repeated within the steps, a label that is not the seed's."""
    bad = 0
    deg = indptr[1:] - indptr[:-1]
    seen = torch.cat([st["seeds"].long() for st in steps])
    bad += int(seen.numel() - torch.unique(seen).numel())
    bad += int((~train_mask[seen]).sum())
    for st in steps:
        seeds = st["seeds"].long()
        B = seeds.shape[0]
        bad += int((st["labels"].long() != labels[seeds]).sum())
        parent = seeds.reshape(B, 1)
        for f, layer in zip(reversed(list(fanouts)), st["layers"]):
            child = layer.long().reshape(B, -1)
            if child.shape[1] != parent.shape[1] * f:
                return bad + 1
            par = parent.repeat_interleave(f, dim=1)
            iso = deg[par] == 0
            hit = in_rows(indptr, indices, par.reshape(-1), child.reshape(-1)).reshape(par.shape)
            bad += int((~torch.where(iso, child == par, hit)).sum())
            parent = child
    return bad


def mask_faults(mask_shapes: Callable, model: dict, steps: List[dict]) -> int:
    """Count the recorded dropout masks of the wrong number or shape, against
    the architecture's ``mask_shapes(model, B, widths)`` (its reference's)
    at each step's batch and level widths."""
    bad = 0
    for st in steps:
        B = st["seeds"].shape[0]
        widths = [1] + [l.reshape(B, -1).shape[1] for l in st["layers"]]
        want = mask_shapes(model, B, widths)
        got = [tuple(m.shape) for m in st["masks"]]
        bad += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    return bad

"""Optimizers of the port, as plain tensor functions with device-resident
state (no ``.item()`` inside a step).

Port of ``falcon_ttdforgnns_tpu/train/optim.py``: optax-parity Adam/AdamW
for the dense params, the branch-free ReduceLROnPlateau, and the constants
the fused core update shares with them.  The TT-core optimizers other than
Adam (sgd, adagrad, rowwise_adagrad) are ROADMAP B5/B6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

ADAGRAD_EPS = 1e-10
ROWWISE_ADAGRAD_EPS = 1e-8
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def auto_plateau_patience(patience: int) -> int:
    """``--plateau-patience -1`` (auto) is 800 in f32, the reference's
    ReduceLROnPlateau patience; 0 disables the scheduler."""
    return 800 if patience < 0 else patience


@dataclass
class AdamState:
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: torch.Tensor  # int32 scalar on the device


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(m=[torch.zeros_like(p) for p in params],
                     v=[torch.zeros_like(p) for p in params],
                     count=torch.zeros((), dtype=torch.int32, device=params[0].device))


def bias_corrections(count: torch.Tensor, b1: float = ADAM_B1,
                     b2: float = ADAM_B2):
    """(1 - b1^t, 1 - b2^t) in f32 on count's device, without a host sync
    (``torch.full_like`` fills on the device; a ``torch.tensor`` would copy
    from the host)."""
    t = count.to(torch.float32)
    return (1.0 - torch.pow(torch.full_like(t, b1), t),
            1.0 - torch.pow(torch.full_like(t, b2), t))


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, lr: float, scale: torch.Tensor,
                weight_decay: float = 0.0, b1: float = ADAM_B1,
                b2: float = ADAM_B2, eps: float = ADAM_EPS) -> None:
    """One in-place step of ``optax.adam`` (``adamw`` when weight_decay >
    0) followed by the plateau ``scale`` on the update:
    p += scale * -lr * (m_hat / (sqrt(v_hat) + eps) [+ wd * p])."""
    state.count += 1
    bc1, bc2 = bias_corrections(state.count, b1, b2)
    for p, g, m, v in zip(params, grads, state.m, state.v):
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay > 0.0:
            u = u + weight_decay * p
        p.add_(scale * (-lr * u))


@dataclass
class PlateauState:
    scale: torch.Tensor          # current lr multiplier
    best_value: torch.Tensor     # best (smoothed) loss seen
    plateau_count: torch.Tensor  # steps since improvement
    ema: torch.Tensor            # smoothed loss (= raw value when smoothing=0)


def plateau_init(device) -> PlateauState:
    return PlateauState(
        scale=torch.ones((), dtype=torch.float32, device=device),
        best_value=torch.full((), float("inf"), dtype=torch.float32, device=device),
        plateau_count=torch.zeros((), dtype=torch.int32, device=device),
        ema=torch.full((), float("inf"), dtype=torch.float32, device=device))


@torch.no_grad()
def reduce_on_plateau(state: PlateauState, value: torch.Tensor,
                      patience: int = 800, factor: float = 0.5,
                      rtol: float = 1e-4, atol: float = 0.0,
                      min_scale: float = 0.0,
                      smoothing: float = 0.0) -> PlateauState:
    """Branch-free ReduceLROnPlateau stepped on every train loss
    (``torch.optim.lr_scheduler.ReduceLROnPlateau`` semantics with
    cooldown 0); ``smoothing`` feeds it an EMA of the loss instead."""
    v = value.to(torch.float32)
    if smoothing > 0.0:
        v = torch.where(torch.isinf(state.ema), v,
                        (1 - smoothing) * state.ema + smoothing * v)
    improved = v < (1 - rtol) * state.best_value - atol
    best = torch.where(improved, v, state.best_value)
    pc = torch.where(improved, torch.zeros_like(state.plateau_count),
                     state.plateau_count + 1)
    hit = pc >= patience
    scale = torch.clamp(torch.where(hit, state.scale * factor, state.scale),
                        min=min_scale)
    pc = torch.where(hit, torch.zeros_like(pc), pc)
    return PlateauState(scale=scale, best_value=best, plateau_count=pc, ema=v)

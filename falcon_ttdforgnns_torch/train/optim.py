"""Optimizers of the port, as plain tensor functions with device-resident
state (no ``.item()`` inside a step).

Port of ``falcon_ttdforgnns_tpu/train/optim.py``: optax-parity Adam/AdamW
for the dense params, the routed TT-core optimizers (``sgd``,
``tt_adagrad``, ``rowwise_adagrad`` with the reference's eps convention),
the hot-row cache's group (``rowwise_adagrad`` at the trainer's lr, the
reference trainer's ``cache_optimizer``), the branch-free
ReduceLROnPlateau, whose scale multiplies every group's update as
``optax.chain`` applies it, and the constants the fused core updates share
with them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

from ..ops.adam import adam_f32_apply

ADAGRAD_EPS = 1e-10
ROWWISE_ADAGRAD_EPS = 1e-8
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
TT_OPTIMIZERS = ("adam", "sgd", "adagrad", "rowwise_adagrad")


def auto_plateau_patience(patience: int, bf16_tower: bool = False) -> int:
    """``--plateau-patience -1`` (auto) is 800 in f32, the reference's
    ReduceLROnPlateau patience, and 0 (off) under a bf16 tower, whose loss
    noise the ratchet would read as a plateau (JAX ``trainer.py:248-259``);
    0 disables the scheduler."""
    if patience >= 0:
        return patience
    return 0 if bf16_tower else 800


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
                state: AdamState, lr: float, scale: Union[torch.Tensor, float],
                weight_decay: float = 0.0, b1: float = ADAM_B1,
                b2: float = ADAM_B2, eps: float = ADAM_EPS) -> None:
    """One in-place step of ``optax.adam`` (``adamw`` when weight_decay >
    0) followed by the plateau ``scale`` on the update:
    p += scale * -lr * (m_hat / (sqrt(v_hat) + eps) [+ wd * p]).
    CPU tensors take :func:`adam_plain`; CUDA tensors the kernel
    ``adam_f32`` (``ops/adam.py``), one launch for the list, bit-identical
    to :func:`adam_plain` on the card."""
    state.count += 1
    bc1, bc2 = bias_corrections(state.count, b1, b2)
    if any(p.is_cuda for p in params):
        adam_f32_apply(params, grads, state.m, state.v, bc1, bc2, lr, scale, weight_decay,
                       b1, b2, eps)
    else:
        adam_plain(params, grads, state.m, state.v, bc1, bc2, lr, scale, weight_decay,
                   b1, b2, eps)


@torch.no_grad()
def adam_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], bc1: torch.Tensor,
               bc2: torch.Tensor, lr: float, scale: Union[torch.Tensor, float],
               weight_decay: float = 0.0, b1: float = ADAM_B1, b2: float = ADAM_B2,
               eps: float = ADAM_EPS) -> None:
    """:func:`adam_update`'s step after its count and bias corrections, in
    plain PyTorch: the version for CPU tensors, and what the kernel is
    held to on the card."""
    for p, g, m, v in zip(params, grads, ms, vs):
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay > 0.0:
            u = u + weight_decay * p
        p.add_(scale * (-lr * u))


def tt_acc_init(cores: Sequence[torch.Tensor], tt_optimizer: str
                ) -> Optional[List[torch.Tensor]]:
    """Adagrad accumulators of the TT cores: shaped like each core for
    ``adagrad``, one per p-row, (p_k,), for ``rowwise_adagrad``; None for
    the optimizers without one."""
    if tt_optimizer == "adagrad":
        return [torch.zeros_like(c) for c in cores]
    if tt_optimizer == "rowwise_adagrad":
        return [torch.zeros(c.shape[:1], dtype=c.dtype, device=c.device) for c in cores]
    return None


@torch.no_grad()
def core_update(cores: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                accs: Optional[Sequence[torch.Tensor]], tt_optimizer: str,
                lr: float, scale: torch.Tensor) -> None:
    """One in-place step of the routed TT-core optimizer (JAX
    ``optim.py:56-106`` and ``optax.sgd``) followed by the plateau
    ``scale`` on the update, as ``optax.chain`` applies it:

    * ``sgd``: ``u = -lr g``;
    * ``adagrad``: ``a += g^2``, ``u = -lr g / (sqrt(a) + 1e-10)``;
    * ``rowwise_adagrad``: ``a += mean(g^2)`` over each p-row,
      ``u = -(lr / (sqrt(a) + 1e-8)) g``."""
    for k, (c, g) in enumerate(zip(cores, grads)):
        if tt_optimizer == "sgd":
            u = -lr * g
        elif tt_optimizer == "adagrad":
            a = accs[k].add_(g * g)
            u = -lr * g / (torch.sqrt(a) + ADAGRAD_EPS)
        elif tt_optimizer == "rowwise_adagrad":
            u = _rowwise_adagrad(g, accs[k], lr)
        else:
            raise ValueError(f"no routed core update for {tt_optimizer!r}")
        c.add_(scale * u)


def _rowwise_adagrad(g: torch.Tensor, acc: torch.Tensor, lr: float) -> torch.Tensor:
    """JAX ``rowwise_adagrad``'s update of one parameter (rows on axis 0):
    ``acc += mean(g^2)`` over each row, in place, then
    ``u = -(lr / (sqrt(acc) + 1e-8)) g``."""
    a = acc.add_((g * g).mean(dim=tuple(range(1, g.dim()))))
    step = lr / (torch.sqrt(a) + ROWWISE_ADAGRAD_EPS)
    return -step.reshape((-1,) + (1,) * (g.dim() - 1)) * g


@dataclass
class CacheOptState:
    """The state of the cache rows' group: ``rowwise_adagrad``'s
    accumulator (K,) at ``lr``."""
    lr: float
    acc: torch.Tensor


def cache_opt_init(weight: torch.Tensor, lr: float) -> CacheOptState:
    """The cache group's optimizer on ``cache_weight`` (K, D): JAX
    ``make_optimizer``'s default ``cache_optimizer``, ``rowwise_adagrad``
    at ``cache_lr`` = lr, which is all its trainer builds."""
    return CacheOptState(lr, torch.zeros(weight.shape[:1], dtype=weight.dtype,
                                         device=weight.device))


@torch.no_grad()
def cache_update(weight: torch.Tensor, grad: torch.Tensor, state: CacheOptState,
                 scale: torch.Tensor) -> None:
    """One in-place step of the cache group, times the plateau ``scale``."""
    weight.add_(scale * _rowwise_adagrad(grad, state.acc, state.lr))


@torch.no_grad()
def reset_cache_opt_state(state: CacheOptState) -> None:
    """A fresh state for the cache group, in place: a populate re-sorts the
    id table, so a slot's accumulator would scale another row's updates
    (JAX ``reset_cache_opt_state``)."""
    state.acc.zero_()


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

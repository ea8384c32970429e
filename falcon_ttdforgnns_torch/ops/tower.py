"""The bf16 fan-out mean of the SAGE conv tower: the wrappers of the Hopper
kernels ``fanout_mean_bf16`` and ``fanout_mean_bf16_bwd``
(``csrc/tower_kernels.cu``), their plain PyTorch versions, and
:func:`fanout_mean_bf16`, the differentiable mean.

The JAX package's bf16 tower means the fan-out neighbours with
``jnp.mean(axis=2, dtype=bfloat16)`` (``models/sage.py``), an XLA
reduction that sums the f slices left to right, rounding every partial sum
to bf16, and divides the sum by f with one more rounding; the gradient of
that ``sum / f`` is ``bf16(g / f)`` on every slice.  PyTorch's bf16
``mean`` accumulates in f32 and rounds once, which differs in most
outputs, so the port computes the reference's sum here.  This is no TPU
kernel's port: it is a kernel of the port only, one launch where a loop of
bf16 adds would take f.  A wrapper runs the plain version only for tensors
on the CPU; for a CUDA tensor it launches its kernel or raises.  Every
launch adds one to its entry in :func:`launch_counts`.
"""

from __future__ import annotations

import torch

from . import _build

KERNELS = ("fanout_mean_bf16", "fanout_mean_bf16[bwd]")
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


def fanout_mean_bf16_plain(nb: torch.Tensor) -> torch.Tensor:
    """(..., f, d) bf16 -> (..., d) bf16: the f slices summed left to right
    with a bf16 rounding after every add, then the sum divided by f in f32
    and rounded to bf16."""
    f = nb.shape[-2]
    acc = nb[..., 0, :]
    for j in range(1, f):
        acc = acc + nb[..., j, :]
    return (acc.float() / f).to(torch.bfloat16)


def fanout_mean_bf16_bwd_plain(g: torch.Tensor, f: int) -> torch.Tensor:
    """(..., d) bf16 -> (..., f, d) bf16: ``bf16(g / f)`` on every slice."""
    return (g.float() / f).to(torch.bfloat16).unsqueeze(-2).expand(
        *g.shape[:-1], f, g.shape[-1]).contiguous()


def _launch(fn: str, x: torch.Tensor, rows: int, f: int, d: int, out_shape) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{fn} takes bfloat16, not {x.dtype}")
    x = x.contiguous()
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    rc = getattr(_build.library("tower_kernels"), fn)(
        x.data_ptr(), rows, f, d, out.data_ptr(), _build.current_stream(x.get_device()))
    _build.check(rc, fn, "tower_kernels")
    return out


def fanout_mean_bf16_fwd(nb: torch.Tensor) -> torch.Tensor:
    """The kernel's forward: (..., f, d) bf16 -> (..., d) bf16."""
    if nb.device.type == "cpu":
        return fanout_mean_bf16_plain(nb)
    if nb.device.type != "cuda":
        raise ValueError(f"fanout_mean_bf16 takes a CUDA or CPU tensor, got {nb.device}")
    *lead, f, d = nb.shape
    rows = nb.numel() // max(f * d, 1)
    out = _launch("fanout_mean_bf16", nb, rows, f, d, (*lead, d))
    if rows:
        _launches["fanout_mean_bf16"] += 1
    return out


def fanout_mean_bf16_bwd(g: torch.Tensor, f: int) -> torch.Tensor:
    """The kernel's backward: (..., d) bf16 -> (..., f, d) bf16."""
    if g.device.type == "cpu":
        return fanout_mean_bf16_bwd_plain(g, f)
    if g.device.type != "cuda":
        raise ValueError(f"fanout_mean_bf16_bwd takes a CUDA or CPU tensor, got {g.device}")
    *lead, d = g.shape
    rows = g.numel() // max(d, 1)
    out = _launch("fanout_mean_bf16_bwd", g, rows, f, d, (*lead, f, d))
    if rows:
        _launches["fanout_mean_bf16[bwd]"] += 1
    return out


class FanoutMeanBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nb: torch.Tensor) -> torch.Tensor:
        ctx.f = nb.shape[-2]
        return fanout_mean_bf16_fwd(nb)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return fanout_mean_bf16_bwd(g.to(torch.bfloat16), ctx.f)


def fanout_mean_bf16(nb: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``mean(axis=-2, dtype=bfloat16)`` of a bf16
    (..., f, d) tensor, bit for bit, with its gradient."""
    return FanoutMeanBF16.apply(nb)

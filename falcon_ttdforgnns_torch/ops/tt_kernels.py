"""Wrappers of the Hopper TT kernels (``csrc/tt_kernels.cu``), their plain
PyTorch versions, and the differentiable lookup :class:`TTLookup`.

Port of ``falcon_ttdforgnns_tpu/ops/tt_pallas.py`` for the kernels on the
main path:

=================  =====================================  ==================
wrapper            replaces (TPU kernel)                  plain version
=================  =====================================  ==================
``tt_fwd``         ``tt_pallas.py:_fwd_kernel``           ``tt_fwd_plain``
``tt_grads``       ``tt_pallas.py:_bwd_kernel``           ``tt_grads_plain``
``tt_adam_apply``  ``tt_pallas.py:_adam_kernel`` (with    ``tt_adam_plain``
                   ``tt_grads``: two launches)
=================  =====================================  ==================

What bounds each kernel on the card and what its design does about it is
written at the top of the CUDA source.  A wrapper runs the plain version
only for tensors on the CPU; for a CUDA tensor it launches its kernel or
raises.  Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .tt_lookup import tt_core_grads, tt_lookup_gather
from .tt_shapes import TTShapes


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"TT kernels take tensors on one CUDA device or on "
                         f"the CPU, got {sorted(str(t.device) for t in tensors)}")
    return False


def _spec(shapes: TTShapes):
    if shapes.ndim not in (2, 3, 4):
        raise ValueError("the TT kernels support 2-4 cores")
    pad = 4 - shapes.ndim
    vals = ([shapes.ndim] + list(shapes.p_shapes) + [0] * pad
            + list(shapes.q_shapes) + [0] * pad
            + list(shapes.full_ranks) + [0] * pad
            + list(shapes.strides) + [0] * pad)
    return (ctypes.c_int * len(vals))(*vals)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_cores(shapes: TTShapes, cores: Sequence[torch.Tensor]) -> None:
    if len(cores) != shapes.ndim:
        raise ValueError(f"expected {shapes.ndim} cores, got {len(cores)}")
    for k, c in enumerate(cores):
        _check(c, f"core {k}", torch.float32, shapes.core_shape(k))


def _core_ptrs(cores: Sequence[torch.Tensor]):
    ptrs = [c.data_ptr() for c in cores]
    return ptrs + [None] * (4 - len(ptrs))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------------ tt_fwd
def tt_fwd_plain(shapes: TTShapes, cores: Sequence[torch.Tensor],
                 ids: torch.Tensor) -> torch.Tensor:
    return tt_lookup_gather(shapes, cores, ids)


def tt_fwd(shapes: TTShapes, cores: Sequence[torch.Tensor],
           ids: torch.Tensor) -> torch.Tensor:
    """TT row lookup: ids (B,) int32 -> (B, D) f32."""
    if _on_cpu(ids, *cores):
        return tt_fwd_plain(shapes, cores, ids)
    B = ids.shape[0]
    _check(ids, "ids", torch.int32, (B,))
    _check_cores(shapes, cores)
    out = torch.empty((B, shapes.embedding_dim), dtype=torch.float32,
                      device=ids.device)
    if B == 0:
        return out
    rc = _build.library().tt_fwd(ids.data_ptr(), B, _spec(shapes),
                                 *_core_ptrs(cores), out.data_ptr(), _stream())
    _build.check(rc, "tt_fwd")
    tt_fwd.launches += 1
    return out


tt_fwd.launches = 0


# ---------------------------------------------------------------- tt_grads
def tt_grads_plain(shapes: TTShapes, cores: Sequence[torch.Tensor],
                   ids: torch.Tensor, d_out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tt_core_grads(shapes, cores, ids, d_out)


def tt_grads(shapes: TTShapes, cores: Sequence[torch.Tensor], ids: torch.Tensor,
             d_out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Dense per-core gradients of a TT lookup from ids (B,) int32 and
    d_out (B, D) f32; duplicate ids accumulate."""
    if _on_cpu(ids, d_out, *cores):
        return tt_grads_plain(shapes, cores, ids, d_out)
    B = ids.shape[0]
    _check(ids, "ids", torch.int32, (B,))
    _check(d_out, "d_out", torch.float32, (B, shapes.embedding_dim))
    _check_cores(shapes, cores)
    out = torch.zeros((shapes.num_tt_params,), dtype=torch.float32, device=ids.device)
    if B > 0:
        rc = _build.library().tt_grads(ids.data_ptr(), d_out.data_ptr(), B,
                                       _spec(shapes), *_core_ptrs(cores),
                                       out.data_ptr(), _stream())
        _build.check(rc, "tt_grads")
        tt_grads.launches += 1
    grads, off = [], 0
    for k in range(shapes.ndim):
        n = cores[k].numel()
        grads.append(out[off:off + n].view(shapes.core_shape(k)))
        off += n
    return tuple(grads)


tt_grads.launches = 0


# ----------------------------------------------------------- tt_adam_apply
def tt_adam_plain(cores, ms, vs, grads, scal, b1: float, b2: float,
                  eps: float) -> None:
    """In-place Adam step on the cores with scal = [lr_eff, c1, c2]
    (optax ``scale_by_adam`` with bias corrections c1 = 1/(1-b1^t),
    c2 = 1/(1-b2^t) computed by the caller)."""
    lr, c1, c2 = scal[0], scal[1], scal[2]
    for c, m, v, g in zip(cores, ms, vs, grads):
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        c.sub_(lr * (m * c1) / (torch.sqrt(v * c2) + eps))


def tt_adam_apply(cores, ms, vs, grads, scal: torch.Tensor, b1: float,
                  b2: float, eps: float) -> None:
    """In-place Adam step on the TT cores and their moments; ``scal`` is a
    (3,) f32 device tensor, read by the kernel without a host sync."""
    if _on_cpu(scal, *cores, *ms, *vs, *grads):
        return tt_adam_plain(cores, ms, vs, grads, scal, b1, b2, eps)
    T = len(cores)
    if not (len(ms) == len(vs) == len(grads) == T) or not 1 <= T <= 4:
        raise ValueError("tt_adam_apply takes 1-4 cores with one m, v, g each")
    _check(scal, "scal", torch.float32, (3,))
    for k in range(T):
        for name, t in (("m", ms[k]), ("v", vs[k]), ("g", grads[k])):
            _check(t, f"{name}_{k}", torch.float32, cores[k].shape)
        _check(cores[k], f"core {k}", torch.float32, cores[k].shape)

    def ptrs(ts):
        return (ctypes.c_void_p * T)(*[t.data_ptr() for t in ts])

    sizes = (ctypes.c_longlong * T)(*[c.numel() for c in cores])
    rc = _build.library().tt_adam_apply(
        T, sizes, ptrs(cores), ptrs(ms), ptrs(vs), ptrs(grads), scal.data_ptr(),
        b1, 1.0 - b1, b2, 1.0 - b2, eps, _stream())
    _build.check(rc, "tt_adam_apply")
    tt_adam_apply.launches += 1


tt_adam_apply.launches = 0

KERNELS = (tt_fwd, tt_grads, tt_adam_apply)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ----------------------------------------------------------- fused update
def tt_fused_adam(shapes: TTShapes, cores, ms, vs, ids: torch.Tensor,
                  d_out: torch.Tensor, scal: torch.Tensor, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8) -> None:
    """Batch-total core gradients, then one Adam step, in place: the port of
    ``tt_fused_adam_pallas`` (two launches on the card)."""
    grads = tt_grads(shapes, cores, ids, d_out)
    tt_adam_apply(cores, ms, vs, grads, scal, b1, b2, eps)


# ------------------------------------------------------ differentiable op
class TTLookup(torch.autograd.Function):
    """Differentiable TT lookup: ``tt_fwd`` forward, ``tt_grads`` backward
    (mirrors ``tt_lookup_fused``).  ids get no gradient."""

    @staticmethod
    def forward(ctx, shapes: TTShapes, ids: torch.Tensor, *cores: torch.Tensor):
        ctx.shapes = shapes
        ctx.save_for_backward(ids, *cores)
        return tt_fwd(shapes, cores, ids)

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        ids, *cores = ctx.saved_tensors
        grads = tt_grads(ctx.shapes, cores, ids, d_out.contiguous())
        return (None, None, *grads)


def tt_lookup_fused(shapes: TTShapes, cores: Sequence[torch.Tensor],
                    ids: torch.Tensor) -> torch.Tensor:
    return TTLookup.apply(shapes, ids, *cores)

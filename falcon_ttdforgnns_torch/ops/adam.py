"""The wrapper of the dense parameters' Adam kernel ``adam_f32``
(``csrc/optim_kernels.cu``).

No TPU kernel's port: the JAX package leaves the dense Adam to optax under
XLA, which fuses it.  :func:`adam_f32_apply` takes CUDA tensors only and
launches one kernel for a list of up to ``MAX_TENSORS`` tensors (one more
for each further ``MAX_TENSORS``); it raises on what the kernel does not
take.  Its plain version is the body of ``train/optim.py``
``adam_update``, which runs it for CPU tensors and this wrapper for CUDA
tensors.  Every launch adds one to ``launch_counts()["adam_f32"]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from . import _build

KERNELS = ("adam_f32",)
MAX_TENSORS = 64  # kMaxTensors of the kernel's launch parameters
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


def _check_scalar(t: torch.Tensor, name: str, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.numel() != 1:
        raise TypeError(f"adam_f32: {name} must be a float32 tensor of one value")
    if t.device != device:
        raise ValueError(f"adam_f32: {name} is on {t.device}, the parameters on {device}")


def adam_f32_apply(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                   ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                   bc1: torch.Tensor, bc2: torch.Tensor, lr: float,
                   scale: Union[torch.Tensor, float], weight_decay: float,
                   b1: float, b2: float, eps: float) -> None:
    """One in-place Adam step over f32 CUDA tensors, bit-identical to
    ``adam_update``'s plain body on the card: each ``params[k]`` with its
    gradient ``grads[k]`` and moments ``ms[k]``, ``vs[k]``, all contiguous,
    of one shape, on one CUDA device.  ``bc1``, ``bc2``: the bias
    corrections (one-value f32 tensors on that device); ``scale``: the
    plateau scale, such a tensor or a number."""
    n = len(params)
    if not len(grads) == len(ms) == len(vs) == n:
        raise ValueError(f"adam_f32: {n} params, {len(grads)} grads, {len(ms)} first and "
                         f"{len(vs)} second moments")
    if n == 0:
        return
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"adam_f32 takes CUDA tensors, got {dev} (the plain version is "
                         f"adam_update's body)")
    _check_scalar(bc1, "bc1", dev)
    _check_scalar(bc2, "bc2", dev)
    if isinstance(scale, torch.Tensor):
        _check_scalar(scale, "scale", dev)
        scale_ptr, scale_value = scale.data_ptr(), 1.0
    else:
        scale_ptr, scale_value = None, float(scale)
    quads = list(zip(params, grads, ms, vs))
    for k, quad in enumerate(quads):
        p = quad[0]
        for name, t in zip(("param", "grad", "m", "v"), quad):
            if t.dtype != torch.float32:
                raise TypeError(f"adam_f32: {name} {k} is {t.dtype}, not float32")
            if t.device != dev:
                raise ValueError(f"adam_f32: {name} {k} is on {t.device}, param 0 on {dev}")
            if t.shape != p.shape:
                raise ValueError(f"adam_f32: {name} {k} has shape {tuple(t.shape)}, its param "
                                 f"{tuple(p.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"adam_f32: {name} {k} must be contiguous")
    lib = _build.library("optim_kernels")
    stream = _build.current_stream(params[0].get_device())
    for lo in range(0, n, MAX_TENSORS):
        group = quads[lo:lo + MAX_TENSORS]
        k = len(group)
        ptrs = [(ctypes.c_void_p * k)(*(t[j].data_ptr() for t in group)) for j in range(4)]
        sizes = [t[0].numel() for t in group]
        rc = lib.adam_f32_apply(
            k, *ptrs, (ctypes.c_longlong * k)(*sizes), bc1.data_ptr(), bc2.data_ptr(),
            scale_ptr, scale_value, lr, weight_decay, int(weight_decay > 0.0), b1, 1.0 - b1,
            b2, 1.0 - b2, eps, stream)
        _build.check(rc, "adam_f32", "optim_kernels")
        if any(sizes):
            _launches["adam_f32"] += 1

"""Wrappers of the Hopper TT kernels (``csrc/tt_kernels.cu``), their plain
PyTorch versions, and the differentiable lookups :class:`TTLookup`,
:class:`TTLookupBF16` and :class:`TTLookupBF16SR`.

Port of ``falcon_ttdforgnns_tpu/ops/tt_pallas.py``:

=====================  ========================================  ====================
wrapper                replaces (TPU kernel)                     plain version
=====================  ========================================  ====================
``tt_fwd``             ``_fwd_kernel`` (f32 or bf16 store)       ``tt_fwd_plain``
``tt_fwd_sr``          ``_fwd_kernel_sr`` (stochastic rounding)  ``tt_fwd_sr_plain``
``tt_grads``           ``_bwd_kernel`` (f32 or bf16 ``d_out``)   ``tt_grads_plain``
``tt_adam_apply``      ``_adam_kernel`` (with ``tt_grads``)      ``tt_adam_plain``
``tt_sgd_apply``       ``_sgd_kernel`` (with ``tt_grads``)       ``tt_sgd_plain``
``tt_adagrad_apply``   ``_adagrad_kernel`` (with ``tt_grads``)   ``tt_adagrad_plain``
=====================  ========================================  ====================

Each fused update of the TPU (one ``pallas_call``) is two launches on the
card: ``tt_grads``, then the in-place update (``tt_fused_adam``,
``tt_fused_sgd``, ``tt_fused_adagrad``).  What bounds each kernel on the
card and what its design does about it is written at the top of the CUDA
source.  ``tt_grads`` walks the ids in sorted order (:func:`grouped_order`)
so that ids of one prefix share the chain's work; :func:`tt_grads_grouped_plain`
repeats that walk in plain PyTorch (equal ids summed, one flush per prefix
within a chunk), and :func:`grouped_counts` counts its pieces and
segments, what the kernel's time depends on.  A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches its
kernel or raises.  Every launch adds one to
its entry in :func:`launch_counts`, one entry per kernel variant
(``KERNELS``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .tt_lookup import tt_core_grads, tt_digits, tt_lookup_gather
from .tt_shapes import TTShapes

KERNELS = ("tt_fwd", "tt_fwd[bf16]", "tt_fwd_sr", "tt_grads", "tt_grads[bf16]",
           "tt_adam_apply", "tt_sgd_apply", "tt_adagrad_apply",
           "tt_adagrad_apply[rowwise]")
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    """Zero every launch count and the update wrappers' argument-cache
    misses (:func:`arg_cache_misses`)."""
    global _arg_misses
    for name in KERNELS:
        _launches[name] = 0
    _arg_misses = 0


def launch_counts() -> dict:
    return dict(_launches)


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


# ------------------------------------------------------------------ tt_fwd
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}


def tt_fwd_plain(shapes: TTShapes, cores: Sequence[torch.Tensor],
                 ids: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f32 rows, then ``.to(out_dtype)``: round to nearest even for bf16,
    as JAX's ``astype``."""
    return tt_lookup_gather(shapes, cores, ids).to(out_dtype)


def _launch_fwd(shapes, cores, ids, out_dtype, out_kind, seed=None, block=0):
    B = ids.shape[0]
    _check(ids, "ids", torch.int32, (B,))
    _check_cores(shapes, cores)
    out = torch.empty((B, shapes.embedding_dim), dtype=out_dtype, device=ids.device)
    if B == 0:
        return out
    rc = _build.library().tt_fwd(ids.data_ptr(), B, _spec(shapes), *_core_ptrs(cores),
                                 out.data_ptr(), out_kind,
                                 None if seed is None else seed.data_ptr(), block,
                                 _build.current_stream(ids.get_device()))
    _build.check(rc, "tt_fwd")
    return out


def tt_fwd(shapes: TTShapes, cores: Sequence[torch.Tensor], ids: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """TT row lookup: ids (B,) int32 -> (B, D), stored f32 or bf16 (round
    to nearest even)."""
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"tt_fwd stores float32 or bfloat16, not {out_dtype}")
    if _on_cpu(ids, *cores):
        return tt_fwd_plain(shapes, cores, ids, out_dtype)
    out = _launch_fwd(shapes, cores, ids, out_dtype, _OUT_KIND[out_dtype])
    if ids.shape[0] > 0:
        _launches["tt_fwd" if out_dtype == torch.float32 else "tt_fwd[bf16]"] += 1
    return out


# --------------------------------------------------------------- tt_fwd_sr
_M32 = 0xFFFFFFFF
# the hash block of the stochastically rounded store on the trainer's path:
# the JAX trainer's Pallas grid block (trainer.py:621)
SR_BLOCK = 1024


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    in two 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sr_cast_plain(x: torch.Tensor, seed: torch.Tensor, block: int) -> torch.Tensor:
    """Stochastic rounding of an f32 (B, D) block of lookup rows to bf16,
    bit for bit ``tt_pallas.py:_sr_cast`` as ``_fwd_kernel_sr`` salts it:
    element (b, f) takes the splitmix32 finalizer of
    ``seed * 0x9E3779B9 + (b // block) * D * block + f * block + b % block``
    (mod 2^32), adds its low 16 bits to the f32 bits and truncates.  The
    hash runs in int64 with ``& 0xFFFFFFFF``."""
    B, D = x.shape
    dev = x.device
    b = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    f = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    s = _mul32(seed.reshape(()).to(torch.int64) & _M32, 0x9E3779B9)
    z = (s + _mul32(b // block, D * block) + f * block + b % block) & _M32
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    z = z ^ (z >> 16)
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
    top = ((u + (z & 0xFFFF)) >> 16) & 0xFFFF
    return ((top ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)


def tt_fwd_sr_plain(shapes: TTShapes, cores: Sequence[torch.Tensor],
                    ids: torch.Tensor, seed: torch.Tensor,
                    block: int = SR_BLOCK) -> torch.Tensor:
    return sr_cast_plain(tt_lookup_gather(shapes, cores, ids), seed, block)


def tt_fwd_sr(shapes: TTShapes, cores: Sequence[torch.Tensor], ids: torch.Tensor,
              seed: torch.Tensor, block: int = SR_BLOCK) -> torch.Tensor:
    """TT row lookup stored in bf16 by stochastic rounding: ids (B,) int32,
    ``seed`` one int32 on the ids' device (read by the kernel, no host
    sync), ``block`` the hash's block -> (B, D) bf16."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if _on_cpu(ids, seed, *cores):
        return tt_fwd_sr_plain(shapes, cores, ids, seed, block)
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError(f"seed: expected one int32, got {seed.dtype} {tuple(seed.shape)}")
    out = _launch_fwd(shapes, cores, ids, torch.bfloat16, 2, seed, block)
    if ids.shape[0] > 0:
        _launches["tt_fwd_sr"] += 1
    return out


# ---------------------------------------------------------------- tt_grads
# Sorted positions one warp of the tt_grads kernel takes: 64 makes 14,656
# chunks of the main path's 937,984 ids (3.5 per warp of a full H100) and
# adds at most one segment per chunk to the <= 17,500 prefix runs.  On the
# main path's sampled ids, timed by chip_smoke.py at 32, 64 and 128 on an
# H100, 64 beat 32 by 7% and 128 by 4-5% (PERF.md).  Each function below
# that takes ``chunk`` reads this when it is None.
GRADS_CHUNK = 64


def tt_grads_plain(shapes: TTShapes, cores: Sequence[torch.Tensor],
                   ids: torch.Tensor, d_out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tt_core_grads(shapes, cores, ids, d_out)


def grouped_order(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order in which ``tt_grads`` walks the ids: ascending, so equal
    ids sit side by side and the ids of one prefix (digits d_0..d_{T-2},
    ``id // p_last``) form one run.  (sorted ids, their int64 positions in
    ``ids``), from ``torch.sort``."""
    return torch.sort(ids)


def grouped_walk(shapes: TTShapes, sorted_ids: torch.Tensor,
                 chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the kernel's walk over ``sorted_ids`` in chunks of ``chunk``
    positions starts a piece (one id within one chunk) and a segment (one
    prefix within one chunk): two boolean masks (B,)."""
    B, chunk = sorted_ids.shape[0], chunk or GRADS_CHUNK
    start = torch.arange(B, device=sorted_ids.device) % chunk == 0
    sid = sorted_ids.long()
    prefix = torch.div(sid, shapes.p_last, rounding_mode="floor") % shapes.num_groups
    piece, segment = start.clone(), start.clone()
    piece[1:] |= sid[1:] != sid[:-1]
    segment[1:] |= prefix[1:] != prefix[:-1]
    return piece, segment


def grouped_counts(shapes: TTShapes, ids: torch.Tensor, chunk: Optional[int] = None) -> dict:
    """What ``tt_grads``' work depends on, for these ids: distinct ids,
    prefix runs, pieces (distinct ids, split at chunk starts) and segments
    (prefix runs, split at chunk starts)."""
    sid, _ = grouped_order(ids)
    B = sid.shape[0]
    distinct, prefix_runs = grouped_walk(shapes, sid, max(B, 1))  # one chunk
    piece, segment = grouped_walk(shapes, sid, chunk)
    return {"ids": B, "distinct": int(distinct.sum()), "prefix_runs": int(prefix_runs.sum()),
            "pieces": int(piece.sum()), "segments": int(segment.sum())}


def tt_grads_grouped_plain(shapes: TTShapes, cores: Sequence[torch.Tensor],
                           ids: torch.Tensor, d_out: torch.Tensor,
                           chunk: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """``tt_grads_plain`` computed in the kernel's order: the ids sorted
    (:func:`grouped_order`), the d_out rows of each piece summed into G^;
    per piece the last core's gradient row P_{T-2}^T G^ and its share
    G^ C_{T-1}^T of the segment's chain gradient; per segment that sum
    through cores T-2..0.  Batched over pieces and segments with bmm and
    index_add_, so only the grouping, not the order of the sums, is the
    kernel's."""
    T, fr, q = shapes.ndim, shapes.full_ranks, shapes.q_shapes
    dev = d_out.device
    grads = [torch.zeros(shapes.core_shape(k), dtype=torch.float32, device=dev)
             for k in range(T)]
    if ids.shape[0] == 0:
        return tuple(grads)
    sid, perm = grouped_order(ids)
    piece, segment = grouped_walk(shapes, sid, chunk)
    first = torch.nonzero(piece).squeeze(1)  # each piece's first position
    n_pc = first.shape[0]
    g_hat = torch.zeros((n_pc, shapes.embedding_dim), dtype=torch.float32, device=dev)
    g_hat.index_add_(0, torch.cumsum(piece.long(), 0) - 1, d_out.index_select(0, perm).float())
    digits = tt_digits(shapes, sid.index_select(0, first))
    seg_of = (torch.cumsum(segment.long(), 0) - 1).index_select(0, first)
    n_seg = int(segment.sum())
    seg_first = torch.nonzero(segment.index_select(0, first)).squeeze(1)  # a segment's first piece
    seg_digits = [d.index_select(0, seg_first) for d in digits]
    lefts = [cores[0].index_select(0, seg_digits[0]).reshape(n_seg, -1, fr[1])]
    for k in range(1, T - 1):
        c = cores[k].index_select(0, seg_digits[k]).reshape(n_seg, fr[k], -1)
        lefts.append(torch.bmm(lefts[-1], c).reshape(n_seg, -1, fr[k + 1]))
    # per piece: the last core's gradient row, and G^ C_{T-1}^T into the segment's sum
    L_last = shapes.embedding_dim // q[-1]
    gh = g_hat.reshape(n_pc, L_last, q[-1])
    c_last = cores[-1].index_select(0, digits[-1]).reshape(n_pc, fr[T - 1], q[-1])
    grads[-1].index_add_(0, digits[-1], torch.bmm(
        lefts[-1].index_select(0, seg_of).transpose(1, 2), gh).reshape(n_pc, fr[T - 1], q[-1], 1))
    G = torch.zeros((n_seg, L_last, fr[T - 1]), dtype=torch.float32, device=dev)
    G.index_add_(0, seg_of, torch.bmm(gh, c_last.transpose(1, 2)))
    # per segment: cores T-2 .. 1, then core 0
    for k in range(T - 2, 0, -1):
        G = G.reshape(n_seg, lefts[k - 1].shape[1], -1)  # (L_k, q_k r_{k+1})
        grads[k].index_add_(0, seg_digits[k], torch.bmm(lefts[k - 1].transpose(1, 2), G)
                            .reshape(n_seg, *shapes.core_shape(k)[1:]))
        c = cores[k].index_select(0, seg_digits[k]).reshape(n_seg, fr[k], -1)
        G = torch.bmm(G, c.transpose(1, 2))
    grads[0].index_add_(0, seg_digits[0], G.reshape(n_seg, *shapes.core_shape(0)[1:]))
    return tuple(grads)


def tt_grads(shapes: TTShapes, cores: Sequence[torch.Tensor], ids: torch.Tensor,
             d_out: torch.Tensor, chunk: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Dense per-core f32 gradients of a TT lookup from ids (B,) int32 and
    d_out (B, D) f32 or bf16; duplicate ids accumulate.  On the card: the
    ids sorted (:func:`grouped_order`, counted in this call's time), then
    one kernel over chunks of ``chunk`` (default ``GRADS_CHUNK``) sorted
    positions."""
    if _on_cpu(ids, d_out, *cores):
        return tt_grads_plain(shapes, cores, ids, d_out)
    B = ids.shape[0]
    _check(ids, "ids", torch.int32, (B,))
    bf16 = d_out.dtype == torch.bfloat16
    _check(d_out, "d_out", torch.bfloat16 if bf16 else torch.float32,
           (B, shapes.embedding_dim))
    _check_cores(shapes, cores)
    out = torch.zeros((shapes.num_tt_params,), dtype=torch.float32, device=ids.device)
    if B > 0:
        sid, perm = grouped_order(ids)
        rc = _build.library().tt_grads(sid.data_ptr(), perm.data_ptr(), d_out.data_ptr(),
                                       int(bf16), B, chunk or GRADS_CHUNK, _spec(shapes),
                                       *_core_ptrs(cores), out.data_ptr(),
                                       _build.current_stream(ids.get_device()))
        _build.check(rc, "tt_grads")
        _launches["tt_grads[bf16]" if bf16 else "tt_grads"] += 1
    grads, off = [], 0
    for k in range(shapes.ndim):
        n = cores[k].numel()
        grads.append(out[off:off + n].view(shapes.core_shape(k)))
        off += n
    return tuple(grads)


# ----------------------------------------------------------- update kernels
# The update kernels run in microseconds, so the Python path that launches
# them is most of their cost.  The tensors that live across steps, updated
# in place (the cores and the optimizer state), are validated once per
# argument set, and their ctypes arguments kept under a key of each one's
# address, shape, dtype, device index and contiguity: any change validates
# anew and raises as a first call would.  The gradients (and Adam's scal)
# are new tensors every step, so each call checks them and writes their
# addresses into the set's arguments (_step_ptrs).
_ARGS: dict = {}
_ARGS_MAX = 64
_arg_misses = 0


def arg_cache_misses() -> int:
    """Argument sets validated anew since :func:`reset_launch_counts`; the
    rest of the update launches reused a kept set."""
    return _arg_misses


def _on_card(cores, *rest) -> bool:
    """The one cheap check: the first core on a CUDA device.  Otherwise
    ``_on_cpu`` raises on a device mix before the plain version runs; a CPU
    tensor among CUDA ones fails the checks of the kernel path."""
    if cores and cores[0].is_cuda:
        return True
    return not _on_cpu(*cores, *[t for ts in rest for t in ts])


def _launch_args(name: str, kept, make, *make_args):
    """``make(*make_args)`` (which validates and builds the ctypes
    arguments), once per argument set of the long-lived tensors ``kept``."""
    global _arg_misses
    key = (name, *[(t.data_ptr(), t.shape, t.dtype, t.get_device(), t.is_contiguous())
                   for t in kept])
    args = _ARGS.get(key)
    if args is None:
        _on_cpu(*kept)  # raises on a device mix
        args = make(*make_args)
        if len(_ARGS) >= _ARGS_MAX:
            _ARGS.clear()
        _ARGS[key] = args
        _arg_misses += 1
    return args


def _step_ptrs(arr, cores, grads, dev: int) -> None:
    """Check this step's gradients as a first call would and write their
    addresses into the kept array ``arr``."""
    if len(grads) != len(cores):
        raise ValueError(f"expected {len(cores)} gradients, got {len(grads)}")
    for k, g in enumerate(grads):
        if (g.get_device() != dev or g.dtype is not torch.float32
                or g.shape != cores[k].shape or not g.is_contiguous()):
            if g.get_device() != dev:
                _on_cpu(cores[k], g)  # raises: another device than the cores'
            _check(g, f"g_{k}", torch.float32, cores[k].shape)  # raises
        arr[k] = g.data_ptr()


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _sizes(cores):
    return (ctypes.c_longlong * len(cores))(*[c.numel() for c in cores])


def _check_update(name, cores, grads, *states) -> None:
    T = len(cores)
    if not 1 <= T <= 4 or len(grads) != T or any(len(s) != T for s in states):
        raise ValueError(f"{name} takes 1-4 cores with one gradient (and state) each")
    for k in range(T):
        _check(cores[k], f"core {k}", torch.float32, cores[k].shape)
        _check(grads[k], f"g_{k}", torch.float32, cores[k].shape)


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


def _adam_args(cores, ms, vs, grads):
    _check_update("tt_adam_apply", cores, grads, ms, vs)
    for k in range(len(cores)):
        _check(ms[k], f"m_{k}", torch.float32, cores[k].shape)
        _check(vs[k], f"v_{k}", torch.float32, cores[k].shape)
    return (_build.library().tt_adam_apply, len(cores), _sizes(cores), _ptrs(cores),
            _ptrs(ms), _ptrs(vs), _ptrs(grads), cores[0].get_device())


def tt_adam_apply(cores, ms, vs, grads, scal: torch.Tensor, b1: float,
                  b2: float, eps: float) -> None:
    """In-place Adam step on the TT cores and their moments; ``scal`` is a
    (3,) f32 device tensor, read by the kernel without a host sync."""
    if not _on_card(cores, ms, vs, grads, (scal,)):
        return tt_adam_plain(cores, ms, vs, grads, scal, b1, b2, eps)
    fn, T, n, c, m, v, g, dev = _launch_args("tt_adam_apply", (*cores, *ms, *vs), _adam_args,
                                              cores, ms, vs, grads)
    _step_ptrs(g, cores, grads, dev)
    if scal.get_device() != dev:
        _on_cpu(cores[0], scal)  # raises: another device than the cores'
    _check(scal, "scal", torch.float32, (3,))
    rc = fn(T, n, c, m, v, g, scal.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
            _build.current_stream(dev))
    if rc:
        _build.check(rc, "tt_adam_apply")
    _launches["tt_adam_apply"] += 1


def tt_sgd_plain(cores, grads, lr: float) -> None:
    """In-place SGD step: core -= lr * g."""
    for c, g in zip(cores, grads):
        c.sub_(lr * g)


def _sgd_args(cores, grads):
    _check_update("tt_sgd_apply", cores, grads)
    return (_build.library().tt_sgd_apply, len(cores), _sizes(cores), _ptrs(cores),
            _ptrs(grads), cores[0].get_device())


def tt_sgd_apply(cores, grads, lr: float) -> None:
    """In-place SGD step on the TT cores with a fixed ``lr``, bit for bit
    ``tt_sgd_plain``."""
    if not _on_card(cores, grads):
        return tt_sgd_plain(cores, grads, lr)
    fn, T, n, c, g, dev = _launch_args("tt_sgd_apply", cores, _sgd_args, cores, grads)
    _step_ptrs(g, cores, grads, dev)
    rc = fn(T, n, c, g, lr, _build.current_stream(dev))
    if rc:
        _build.check(rc, "tt_sgd_apply")
    _launches["tt_sgd_apply"] += 1


def tt_adagrad_plain(cores, accs, grads, lr: float, eps: float,
                     rowwise: bool = False) -> None:
    """In-place adagrad step with the reference's eps convention,
    ``a += g^2; core -= lr * g / (sqrt(a) + eps)``; ``rowwise`` keeps one
    accumulator per p-row of each core and adds the row's mean of g^2."""
    for c, a, g in zip(cores, accs, grads):
        if rowwise:
            a.add_((g * g).mean(dim=tuple(range(1, g.dim()))))
            den = (torch.sqrt(a) + eps).reshape((-1,) + (1,) * (g.dim() - 1))
        else:
            a.add_(g * g)
            den = torch.sqrt(a) + eps
        c.sub_(lr * g / den)


def _adagrad_args(cores, accs, grads, rowwise):
    _check_update("tt_adagrad_apply", cores, grads, accs)
    for k, c in enumerate(cores):
        _check(accs[k], f"acc_{k}", torch.float32, c.shape[:1] if rowwise else c.shape)
    rows = (ctypes.c_int * len(cores))(*[c.numel() // c.shape[0] for c in cores])
    return (_build.library().tt_adagrad_apply, len(cores), _sizes(cores), rows,
            _ptrs(cores), _ptrs(accs), _ptrs(grads), cores[0].get_device())


def tt_adagrad_apply(cores, accs, grads, lr: float, eps: float,
                     rowwise: bool = False) -> None:
    """In-place adagrad (``rowwise``: one accumulator of shape (p_k,) per
    core) on the TT cores with a fixed ``lr``."""
    if not _on_card(cores, accs, grads):
        return tt_adagrad_plain(cores, accs, grads, lr, eps, rowwise)
    name = "tt_adagrad_apply[rowwise]" if rowwise else "tt_adagrad_apply"
    fn, T, n, rows, c, a, g, dev = _launch_args(name, (*cores, *accs), _adagrad_args, cores,
                                                accs, grads, rowwise)
    _step_ptrs(g, cores, grads, dev)
    rc = fn(T, n, rows, c, a, g, lr, eps, int(rowwise), _build.current_stream(dev))
    if rc:
        _build.check(rc, "tt_adagrad_apply")
    _launches[name] += 1


# ------------------------------------------------------------ fused updates
def tt_fused_adam(shapes: TTShapes, cores, ms, vs, ids: torch.Tensor,
                  d_out: torch.Tensor, scal: torch.Tensor, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8) -> None:
    """Batch-total core gradients, then one Adam step, in place: the port of
    ``tt_fused_adam_pallas`` (two launches on the card)."""
    grads = tt_grads(shapes, cores, ids, d_out)
    tt_adam_apply(cores, ms, vs, grads, scal, b1, b2, eps)


def tt_fused_sgd(shapes: TTShapes, cores, ids: torch.Tensor, d_out: torch.Tensor,
                 lr: float) -> None:
    """Batch-total core gradients at the pre-step cores, then
    ``core -= lr * g`` in place: the port of ``tt_fused_sgd_pallas``."""
    grads = tt_grads(shapes, cores, ids, d_out)
    tt_sgd_apply(cores, grads, lr)


def tt_fused_adagrad(shapes: TTShapes, cores, accs, ids: torch.Tensor,
                     d_out: torch.Tensor, lr: float, eps: float = 1e-10,
                     rowwise: bool = False) -> None:
    """Batch-total core gradients, then one adagrad (or rowwise adagrad)
    step on the cores and accumulators, in place: the port of
    ``tt_fused_adagrad_pallas``."""
    grads = tt_grads(shapes, cores, ids, d_out)
    tt_adagrad_apply(cores, accs, grads, lr, eps, rowwise)


# ------------------------------------------------------ differentiable ops
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


class TTLookupBF16(torch.autograd.Function):
    """bf16-I/O lookup (mirrors ``tt_lookup_fused_bf16``): the forward
    stores bf16 rows, the backward takes the bf16 cotangent and returns f32
    core gradients."""

    @staticmethod
    def forward(ctx, shapes: TTShapes, ids: torch.Tensor, *cores: torch.Tensor):
        ctx.shapes = shapes
        ctx.save_for_backward(ids, *cores)
        return tt_fwd(shapes, cores, ids, out_dtype=torch.bfloat16)

    backward = staticmethod(TTLookup.backward)


class TTLookupBF16SR(torch.autograd.Function):
    """:class:`TTLookupBF16` with the stochastically rounded store
    (mirrors ``tt_lookup_fused_bf16_sr``, hash block ``SR_BLOCK``); the seed gets
    no gradient and the backward is the round-to-nearest variant's."""

    @staticmethod
    def forward(ctx, shapes: TTShapes, ids: torch.Tensor, seed: torch.Tensor,
                *cores: torch.Tensor):
        ctx.shapes = shapes
        ctx.save_for_backward(ids, *cores)
        return tt_fwd_sr(shapes, cores, ids, seed)

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        ids, *cores = ctx.saved_tensors
        grads = tt_grads(ctx.shapes, cores, ids, d_out.contiguous())
        return (None, None, None, *grads)


def tt_lookup_fused(shapes: TTShapes, cores: Sequence[torch.Tensor],
                    ids: torch.Tensor) -> torch.Tensor:
    return TTLookup.apply(shapes, ids, *cores)


def tt_lookup_fused_bf16(shapes: TTShapes, cores: Sequence[torch.Tensor],
                         ids: torch.Tensor) -> torch.Tensor:
    return TTLookupBF16.apply(shapes, ids, *cores)


def tt_lookup_fused_bf16_sr(shapes: TTShapes, cores: Sequence[torch.Tensor],
                            ids: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return TTLookupBF16SR.apply(shapes, ids, seed, *cores)

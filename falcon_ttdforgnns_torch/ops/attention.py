"""The full-graph GAT aggregation over the CSR rows of the destinations.

No TPU kernel's port: the JAX package has no neighbour-sampled GAT, and
its full-graph GAT leaves the edge softmax to XLA.  :func:`csr_gat` is the
wrapper of the Hopper kernels ``csr_gat_bf16`` and ``csr_gat_f32``
(``csrc/attn_kernels.cu``), which walk each destination row's in-edges once
with an online softmax per head; :func:`csr_gat_plain` is the same function
in plain PyTorch, which the wrapper runs only for tensors on the CPU.  For
a CUDA tensor it launches its kernel or raises.  Every launch adds one to
its entry in :func:`launch_counts`.  Both are forward only: the sampled GAT
trains on the sampler's levels (``models/gat_ns.py``).

The row index is :class:`ops.segment.RowIndex`, which a trainer's
:class:`ops.segment.FullGraph` builds and checks once; the wrapper checks
its arguments against it with the means' :func:`ops.segment.csr_check`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .segment import VECTOR, RowIndex, csr_check

NEGATIVE_SLOPE = 0.2  # leaky_relu on the attention scores
KERNELS = ("csr_gat_bf16", "csr_gat_f32")
PLAIN_CHUNK = 1 << 20  # edges a step of the plain version: (chunk, H, Cp) f32 messages
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


def csr_gat_plain(x: torch.Tensor, el: torch.Tensor, er: torch.Tensor, src: torch.Tensor,
                  indptr: torch.Tensor, heads: int, mean: bool) -> torch.Tensor:
    """For each row v < N = len(indptr) - 1 and head h, the softmax over v's
    self-loop and its in-edges (sources ``src[indptr[v]:indptr[v + 1]]``) of
    ``leaky_relu(el[u, h] + er[v, h], 0.2)``, and the weighted sum of the
    source rows' head h of ``x`` (n_x, heads * Cp), in f32; the heads side by
    side (N, heads * Cp), or with ``mean`` their mean (N, Cp); rounded once
    to ``x``'s dtype.  On the CPU each row's sums run in edge order."""
    n, H = indptr.shape[0] - 1, heads
    E, cp = src.shape[0], x.shape[1] // heads
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), indptr.diff(),
                                   output_size=E)
    s = F.leaky_relu(el.index_select(0, src) + er.index_select(0, rows), NEGATIVE_SLOPE)
    s0 = F.leaky_relu(el[:n] + er, NEGATIVE_SLOPE)  # the self-loops
    m = s0.scatter_reduce(0, rows[:, None].expand(-1, H), s, reduce="amax")
    p = torch.exp(s - m.index_select(0, rows))
    p0 = torch.exp(s0 - m)
    den = p0.index_add(0, rows, p)
    acc = p0[:, :, None] * x[:n].float().reshape(n, H, cp)
    for lo in range(0, E, PLAIN_CHUNK):
        msg = x.index_select(0, src[lo:lo + PLAIN_CHUNK]).float().reshape(-1, H, cp)
        acc.index_add_(0, rows[lo:lo + PLAIN_CHUNK], p[lo:lo + PLAIN_CHUNK, :, None] * msg)
    out = acc / den[:, :, None]
    out = out.mean(1) if mean else out.reshape(n, H * cp)
    return out.to(x.dtype)


def csr_gat(x: torch.Tensor, el: torch.Tensor, er: torch.Tensor, index: RowIndex,
            heads: int, mean: bool) -> torch.Tensor:
    """The kernels' wrapper: x (n_x, heads * Cp) bf16 or f32, el (n_x, heads)
    f32, er (N, heads) f32, the row index of N rows -> (N, heads * Cp), or
    (N, Cp) with ``mean``, in x's dtype (see :func:`csr_gat_plain`).  Forward
    only.  On the card Cp must be a multiple of 8 (bf16) or 4 (f32) values,
    16 bytes, and a row at most 128 such loads."""
    n = index.num_rows
    if x.dim() != 2 or x.shape[1] % heads or el.shape != (x.shape[0], heads) or \
            er.shape != (n, heads) or n > x.shape[0]:
        raise ValueError(f"csr_gat: x {tuple(x.shape)}, el {tuple(el.shape)}, er "
                         f"{tuple(er.shape)} for {heads} heads and {n} rows")
    if el.dtype != torch.float32 or er.dtype != torch.float32:
        raise TypeError("csr_gat: el and er are float32")
    if not csr_check("csr_gat", index, x, tuple(VECTOR), (er,), (el,)):
        return csr_gat_plain(x, el, er, index.src, index.indptr, heads, mean)
    cp, vec = x.shape[1] // heads, VECTOR[x.dtype]
    if cp % vec or x.shape[1] > 128 * vec:
        raise ValueError(f"csr_gat: a head's width {cp} is no multiple of {vec} values "
                         f"(16 bytes; pad the heads), or a row of {x.shape[1]} passes "
                         f"{128 * vec} (a warp's 128 loads)")
    x, el, er = x.contiguous(), el.contiguous(), er.contiguous()
    out = torch.empty((n, cp if mean else x.shape[1]), dtype=x.dtype, device=x.device)
    name = "csr_gat_bf16" if x.dtype == torch.bfloat16 else "csr_gat_f32"
    rc = getattr(_build.library("attn_kernels"), name)(
        x.data_ptr(), el.data_ptr(), er.data_ptr(), index.src.data_ptr(),
        index.indptr.data_ptr(), n, heads, cp, int(mean), out.data_ptr(),
        _build.current_stream(x.get_device()))
    _build.check(rc, name, "attn_kernels")
    if n:
        _launches[name] += 1
    return out

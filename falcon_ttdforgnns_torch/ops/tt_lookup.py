"""Plain PyTorch TT-embedding ops: digit decomposition, the gather chain,
full-table reconstruction and the dense per-core gradients.

Port of ``falcon_ttdforgnns_tpu/ops/tt_lookup.py`` (non-grouped paths).
These are the plain versions of the Hopper kernels in
:mod:`.tt_kernels`: the CPU path of every wrapper there, and what each
kernel is held against on the card.  Cores use the native
``(p_k, r_k, q_k, r_{k+1})`` layout.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .tt_shapes import TTShapes

Cores = Sequence[torch.Tensor]  # core k: (p_k, r_k, q_k, r_{k+1})


def tt_digits(shapes: TTShapes, indices: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Row-major TT digits of each index: digit_k = (idx // stride_k) % p_k."""
    idx = indices.long()
    return tuple(torch.div(idx, s, rounding_mode="floor") % p
                 for s, p in zip(shapes.strides, shapes.p_shapes))


def tt_to_full(shapes: TTShapes, cores: Cores) -> torch.Tensor:
    """Materialize the full (num_embeddings, embedding_dim) table."""
    f = cores[0].reshape(shapes.p_shapes[0], shapes.q_shapes[0], -1)
    for k in range(1, shapes.ndim):
        f = torch.einsum("PQr,prqs->PpQqs", f, cores[k])
        f = f.reshape(f.shape[0] * f.shape[1], f.shape[2] * f.shape[3], -1)
    full = f.reshape(f.shape[0], f.shape[1])
    return full[: shapes.num_embeddings, : shapes.embedding_dim]


def _chain(shapes: TTShapes, cores: Cores, digits: Sequence[torch.Tensor],
           start: int, stop: int) -> torch.Tensor:
    """Contract cores[start:stop] gathered at the given digits: returns
    (B, prod(q_start..q_{stop-1}), r_stop)."""
    g = cores[start].index_select(0, digits[start])  # (B, r, q, r')
    B = g.shape[0]
    g = g.reshape(B, g.shape[1] * g.shape[2], g.shape[3])
    for k in range(start + 1, stop):
        c = cores[k].index_select(0, digits[k])
        c = c.reshape(B, c.shape[1], c.shape[2] * c.shape[3])
        g = torch.bmm(g, c).reshape(B, g.shape[1] * cores[k].shape[2], cores[k].shape[3])
    return g


def tt_lookup_gather(shapes: TTShapes, cores: Cores,
                     indices: torch.Tensor) -> torch.Tensor:
    """(B,) ids -> (B, D) rows: gather each core's row, contract the chain.
    Plain version of the ``tt_fwd`` kernel."""
    digits = tt_digits(shapes, indices)
    g = _chain(shapes, cores, digits, 0, shapes.ndim)
    return g.reshape(indices.shape[0], shapes.embedding_dim)


def tt_materialize_rows(shapes: TTShapes, cores: Cores,
                        indices: torch.Tensor) -> torch.Tensor:
    return tt_lookup_gather(shapes, cores, indices)


def _partials(shapes: TTShapes, cores: Cores, digits: Sequence[torch.Tensor]):
    """Left/right partial chains for every core position.

    left[k]:  (B, L_k, r_k)     contraction of cores 0..k-1   (L_0 = 1)
    right[k]: (B, r_{k+1}, R_k) contraction of cores k+1..T-1 (R_{T-1} = 1)
    """
    T = shapes.ndim
    B = digits[0].shape[0]
    fr = shapes.full_ranks
    one = torch.ones((B, 1, 1), dtype=cores[0].dtype, device=cores[0].device)
    lefts: List[torch.Tensor] = [one]
    q = shapes.q_shapes
    g = cores[0].index_select(0, digits[0]).reshape(B, q[0], fr[1])
    lefts.append(g)
    for k in range(1, T - 1):
        c = cores[k].index_select(0, digits[k]).reshape(B, fr[k], q[k] * fr[k + 1])
        lefts.append(torch.bmm(lefts[-1], c).reshape(B, lefts[-1].shape[1] * q[k], fr[k + 1]))

    rights: List[torch.Tensor] = [one] * T
    for k in range(T - 2, -1, -1):
        c = cores[k + 1].index_select(0, digits[k + 1])  # (B, r, q, r')
        g = torch.einsum("brqs,bsR->brqR", c, rights[k + 1])
        rights[k] = g.reshape(B, c.shape[1], c.shape[2] * rights[k + 1].shape[2])
    return lefts, rights


def tt_core_grads(shapes: TTShapes, cores: Cores, indices: torch.Tensor,
                  d_out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Dense per-core gradients of a TT lookup; duplicate ids accumulate
    (``dedup=False`` semantics of the reference — summing over duplicates
    gives the same total).  Plain version of the ``tt_grads`` kernel."""
    B = indices.shape[0]
    digits = tt_digits(shapes, indices)
    lefts, rights = _partials(shapes, cores, digits)
    fr = shapes.full_ranks
    d_out = d_out.to(cores[0].dtype)
    grads = []
    for k in range(shapes.ndim):
        Lk, Rk, qk = lefts[k].shape[1], rights[k].shape[2], shapes.q_shapes[k]
        d = d_out.reshape(B, Lk, qk, Rk)
        # d_core[b, r, q, s] = sum_{l,R} left[b,l,r] d[b,l,q,R] right[b,s,R]
        t = torch.einsum("blr,blqR->brqR", lefts[k], d)
        t = torch.einsum("brqR,bsR->brqs", t, rights[k])
        g = torch.zeros((shapes.p_shapes[k], fr[k], qk, fr[k + 1]),
                        dtype=t.dtype, device=t.device)
        grads.append(g.index_add_(0, digits[k], t))
    return tuple(grads)


def tt_lookup_batched(shapes: TTShapes, cores: Cores, indices: torch.Tensor,
                      batch_count: int = 131072) -> torch.Tensor:
    """Plain lookup chunked by ``batch_count`` ids, so the gathered
    (B, r, q, r') intermediates stay bounded (the reference's
    ``batch_count`` knob).  Differentiable through autograd."""
    B = indices.shape[0]
    if B <= batch_count:
        return tt_lookup_gather(shapes, cores, indices)
    return torch.cat([tt_lookup_gather(shapes, cores, indices[i:i + batch_count])
                      for i in range(0, B, batch_count)])

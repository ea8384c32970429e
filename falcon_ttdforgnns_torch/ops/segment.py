"""SpMM over a COO edge list for full-graph propagation.

Port of ``falcon_ttdforgnns_tpu/ops/segment.py:spmm_sum_chunked`` and
``spmm_mean``.  In the JAX package these are XLA gathers and scatter-adds,
not Pallas kernels; their port is ``index_add_`` over edge chunks, which
bounds the (chunk, D) gathered messages.
"""

from __future__ import annotations

from typing import Optional

import torch


def spmm_sum_chunked(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     num_nodes: int, edge_weight: Optional[torch.Tensor] = None,
                     chunk: int = 1 << 22) -> torch.Tensor:
    """out[v] = sum_{(u->v)} w_e * h[u], scattered chunk by chunk."""
    out = torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype, device=h.device)
    for s in range(0, src.shape[0], chunk):
        msgs = h.index_select(0, src[s:s + chunk])
        if edge_weight is not None:
            msgs = msgs * edge_weight[s:s + chunk, None]
        out.index_add_(0, dst[s:s + chunk], msgs)
    return out


def spmm_mean(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              num_nodes: int, in_deg: Optional[torch.Tensor] = None,
              chunk: int = 1 << 22) -> torch.Tensor:
    """Mean aggregation: sum / in-degree (degree from dst if not given)."""
    s = spmm_sum_chunked(h, src, dst, num_nodes, chunk=chunk)
    if in_deg is None:
        in_deg = torch.bincount(dst, minlength=num_nodes)
    return s / torch.clamp(in_deg.to(h.dtype), min=1.0)[:, None]

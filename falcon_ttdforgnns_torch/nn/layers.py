"""GNN convolution layers (port of ``falcon_ttdforgnns_tpu/nn/layers.py``;
``SAGEConv`` only in this slice)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# lecun_normal: variance 1/fan_in from a normal truncated at +-2 std, whose
# std before truncation is this much larger than after (flax's constant)
_TRUNC_STD = 0.87962566103423978
_CDF_LO, _CDF_HI = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax ``Dense``'s default kernel init on an (out, in) weight; the
    bits differ from jax.random, the distribution does not."""
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        u = torch.rand(w.shape, generator=generator, dtype=w.dtype, device=w.device)
        u = _CDF_LO + (_CDF_HI - _CDF_LO) * u
        w.copy_(torch.erfinv(2 * u - 1) * (math.sqrt(2.0) * std))
    return w


class SAGEConv(nn.Module):
    """GraphSAGE convolution, mean aggregator:
    ``h_v' = W_self h_v + W_neigh mean_{u in N(v)} h_u + b``.

    ``lin_self``/``lin_neigh`` hold the flax params ``self``/``neigh``
    transposed: flax's Dense kernel is (in, out), ``nn.Linear.weight`` is
    (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias, device=device)
        self.lin_neigh = nn.Linear(in_dim, out_dim, bias=False, device=device)
        lecun_normal_(self.lin_self.weight, generator)
        lecun_normal_(self.lin_neigh.weight, generator)
        if use_bias:
            nn.init.zeros_(self.lin_self.bias)

    def forward(self, h_dst: torch.Tensor, h_neigh: torch.Tensor) -> torch.Tensor:
        return self.lin_self(h_dst) + self.lin_neigh(h_neigh)

"""Carry weights from the JAX package into the port.

``params_from_jax`` maps a SAGE flax param tree — given as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, variables["params"])``) — to a
``state_dict`` of :class:`~falcon_ttdforgnns_torch.models.sage.SAGE`:

* ``params["embed"]["tt_core_k"]`` -> ``embed.tt_core_k``;
* ``params["conv_i"]["self"]["kernel"/"bias"]`` -> ``convs.i.lin_self``
  ``weight`` (transposed: flax keeps (in, out), ``nn.Linear`` (out, in))
  and ``bias``;
* ``params["conv_i"]["neigh"]["kernel"]`` -> ``convs.i.lin_neigh.weight``.

``load_jax_variables`` also carries the fused-Adam state
``variables["tt_opt"]`` (``m_k``, ``v_k``, ``t``) into a trainer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, arr in params["embed"].items():
        if not name.startswith("tt_core_"):
            raise ValueError(f"unsupported embedding param {name!r}")
        out[f"embed.{name}"] = torch.tensor(np.asarray(arr, np.float32))
    convs = sorted((n for n in params if n.startswith("conv_")),
                   key=lambda n: int(n.split("_")[1]))
    for n in convs:
        i = int(n.split("_")[1])
        conv = params[n]
        out[f"convs.{i}.lin_self.weight"] = torch.tensor(
            np.asarray(conv["self"]["kernel"], np.float32).T.copy())
        out[f"convs.{i}.lin_self.bias"] = torch.tensor(
            np.asarray(conv["self"]["bias"], np.float32))
        out[f"convs.{i}.lin_neigh.weight"] = torch.tensor(
            np.asarray(conv["neigh"]["kernel"], np.float32).T.copy())
    return out


@torch.no_grad()
def load_jax_variables(trainer, variables: Dict) -> None:
    """Load JAX-initialised (or trained) variables into a port
    :class:`SageTrainer`: the params, and the fused-Adam moments and step
    count when both sides carry them."""
    state = params_from_jax(variables["params"])
    trainer.model.load_state_dict(state, strict=True)
    tt_opt = variables.get("tt_opt")
    if tt_opt is not None and trainer.tt_opt is not None:
        for k in range(len(trainer.cores)):
            trainer.tt_opt.m[k].copy_(torch.tensor(np.asarray(tt_opt[f"m_{k}"])))
            trainer.tt_opt.v[k].copy_(torch.tensor(np.asarray(tt_opt[f"v_{k}"])))
        trainer.tt_opt.count.fill_(int(np.asarray(tt_opt["t"])))

"""Carry weights from the JAX package into the port.

``params_from_jax`` maps a SAGE flax param tree — given as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, variables["params"])``) — to a
``state_dict`` of :class:`~falcon_ttdforgnns_torch.models.sage.SAGE`:

* the embedding's params by :func:`embedding_state_from_jax` under
  ``embed.``: ``tt_core_k`` and ``cache_weight`` of the TT embedding, the
  dense table's ``weight``, the access-counting table's ``table.weight``;
* ``params["conv_i"]["self"]["kernel"/"bias"]`` -> ``convs.i.lin_self``
  ``weight`` (transposed: flax keeps (in, out), ``nn.Linear`` (out, in))
  and ``bias``;
* ``params["conv_i"]["neigh"]["kernel"]`` -> ``convs.i.lin_neigh.weight``.

``load_jax_variables`` also carries the embedding's collections
(``variables["access_counts"]["embed"]["counts"]`` -> ``embed.counts``,
``variables["constants"]["embed"]["feats"]`` -> ``embed.feats``), the fused
optimizer state
``variables["tt_opt"]`` into a trainer: the Adam moments and step count
(``m_k``, ``v_k``, ``t``) or the adagrad accumulators (``acc_k``); the
hot-row cache's metadata ``variables["ttcache"]["embed"]["meta"]``
(``freq``, ``ids``, ``ready``) -> the buffers ``embed.cache_freq``,
``embed.cache_ids``, ``embed.cache_ready``; and, given as ``cache_acc``,
the cache group's rowwise-adagrad accumulator, which the JAX trainer keeps
in its optax state at
``opt_state[0].inner_states["cache"].inner_state["embed"]["cache_weight"]``.

``full_graph_state_from_jax`` maps the variables of the JAX
``FullGraphModel`` (GCN or GAT; ``params`` and ``batch_stats``) to a
``state_dict`` of :class:`~falcon_ttdforgnns_torch.train.full_graph.FullGraphModel`:

* ``params["embed"]["tt_core_k"]`` -> ``embed.tt_core_k``;
* GCN ``params["gnn"]["conv_i"]["Dense_0"]`` -> ``gnn.convs.i.lin``;
* GAT ``params["gnn"]["conv_i"]["fc"]``/``["res_fc"]`` -> ``gnn.convs.i.fc``/
  ``res_fc`` and ``["attn_l"]``/``["attn_r"]`` -> ``gnn.convs.i.attn_l``/
  ``attn_r`` (same (1, H, Do) shape); ``["bias_last"]["bias"]`` ->
  ``gnn.bias_last.bias``;
* ``["linear_i"]`` -> ``gnn.linears.i``; ``["bn_i"]`` ``scale``/``bias`` ->
  ``gnn.bns.i.weight``/``bias``, and ``batch_stats["gnn"]["bn_i"]``
  ``mean``/``var`` -> ``gnn.bns.i.running_mean``/``running_var``.

``rgat_state_from_jax`` maps the params of the JAX ``RGAT`` to a
``state_dict`` of :class:`~falcon_ttdforgnns_torch.models.rgat.RGAT`:
``layer_i/etype_t`` (a GAT layer's ``fc``, ``attn_l``, ``attn_r``) ->
``layers.i.convs.t``, ``layer_i/skip`` -> ``layers.i.skip``, ``out`` ->
``out``.

``mol_gnn_state_from_jax`` maps the variables of the JAX ``MolGNN`` (or of
a ``GNNNode`` alone, with ``node_only``; ``params`` and ``batch_stats``) to
a ``state_dict`` of :class:`~falcon_ttdforgnns_torch.models.gin.MolGNN`
(:class:`~falcon_ttdforgnns_torch.models.gin.GNNNode`):

* ``gnn_node/atom_encoder`` and ``vn_init`` as they are;
* ``gnn_node/conv_l``: ``BondEncoder_0/bond_i/embedding`` ->
  ``convs.l.bond.tables.i.weight``; GIN ``eps``, ``Dense_0``/``Dense_1``
  -> ``lin1``/``lin2``, ``mlp_bn`` -> ``bn``; GCN ``Dense_0`` -> ``lin``,
  ``root_emb``;
* ``gnn_node/bn_l`` -> ``bns.l``; ``gnn_node/vn_mlp_l_j``/``vn_bn_l_j`` ->
  ``vn_lins.(2l + j)``/``vn_bns.(2l + j)``;
* ``pool``: attention ``Dense_0``/``gate_bn``/``Dense_1`` ->
  ``lin1``/``bn``/``lin2``; Set2Set ``lstm_i`` -> ``cells.i``, the gates'
  kernels stacked in the order i, f, g, o into ``weight_ih`` (``ii`` ...)
  and ``weight_hh`` (``hi`` ...), the hidden Dense's biases into
  ``bias_hh``, ``bias_ih`` zero;
* ``graph_pred`` as it is; every BatchNorm's ``scale``/``bias`` ->
  ``weight``/``bias`` and its ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``.

Every flax Dense kernel (in, out) becomes an ``nn.Linear`` weight (out, in).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _linear(out: Dict[str, torch.Tensor], name: str, dense: Dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(dense["kernel"]).T.copy())
    if "bias" in dense:
        out[f"{name}.bias"] = _t(dense["bias"])


def embedding_state_from_jax(variables: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The ``state_dict`` (keys under ``prefix``) of a port embedding module
    from the variables of the JAX one: its params (``tt_core_k``,
    ``cache_weight``, ``weight``, and a submodule's, such as the
    access-counting ``table`` or the one-table ``tables``, nested), and
    its ``access_counts`` (-> ``counts``, int32) and ``constants`` (->
    ``feats``) collections.  Table-batched cores keep their leading table
    axis."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Dict, pre: str) -> None:
        for name, arr in tree.items():
            if isinstance(arr, dict):
                walk(arr, f"{pre}{name}.")
            elif name.startswith("tt_core_") or name in ("cache_weight", "weight"):
                out[pre + name] = _t(arr)
            else:
                raise ValueError(f"unsupported embedding param {name!r}")

    walk(variables.get("params", {}), prefix)
    if "access_counts" in variables:
        out[prefix + "counts"] = torch.tensor(
            np.asarray(variables["access_counts"]["counts"], np.int32))
    if "constants" in variables:
        out[prefix + "feats"] = _t(variables["constants"]["feats"])
    return out


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    out = embedding_state_from_jax({"params": params["embed"]}, "embed.")
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
def load_jax_variables(trainer, variables: Dict, cache_acc=None) -> None:
    """Load JAX-initialised (or trained) variables into a port
    :class:`SageTrainer`: the params, the cache's metadata, and the fused
    optimizer's state (Adam moments and step count, or adagrad
    accumulators) when both sides carry it; ``cache_acc`` (K,) is the
    cache group's accumulator."""
    state = params_from_jax(variables["params"])
    state.update(embedding_state_from_jax(
        {k: variables[k]["embed"] for k in ("access_counts", "constants") if k in variables},
        "embed."))
    if "ttcache" in variables:
        meta = variables["ttcache"]["embed"]["meta"]
        for field in ("freq", "ids", "ready"):
            state[f"embed.cache_{field}"] = torch.tensor(np.asarray(getattr(meta, field)))
    trainer.model.load_state_dict(state, strict=True)
    if cache_acc is not None:
        trainer.cache_opt.acc.copy_(torch.tensor(np.asarray(cache_acc, np.float32)))
    tt_opt = variables.get("tt_opt")
    if tt_opt is None:
        return
    for k in range(len(trainer.cores)):
        if trainer.tt_opt is not None and f"m_{k}" in tt_opt:
            trainer.tt_opt.m[k].copy_(torch.tensor(np.asarray(tt_opt[f"m_{k}"])))
            trainer.tt_opt.v[k].copy_(torch.tensor(np.asarray(tt_opt[f"v_{k}"])))
        if trainer.tt_acc is not None and f"acc_{k}" in tt_opt:
            trainer.tt_acc[k].copy_(torch.tensor(np.asarray(tt_opt[f"acc_{k}"])))
    if trainer.tt_opt is not None and "t" in tt_opt:
        trainer.tt_opt.count.fill_(int(np.asarray(tt_opt["t"])))


def full_graph_state_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables.get("batch_stats", {}).get("gnn", {})
    out: Dict[str, torch.Tensor] = {f"embed.{k}": _t(v) for k, v in params["embed"].items()}
    for name, sub in params["gnn"].items():
        kind, _, i = name.rpartition("_")
        if kind == "conv":
            if "Dense_0" in sub:  # GCN
                _linear(out, f"gnn.convs.{i}.lin", sub["Dense_0"])
            else:  # GAT
                _linear(out, f"gnn.convs.{i}.fc", sub["fc"])
                if "res_fc" in sub:
                    _linear(out, f"gnn.convs.{i}.res_fc", sub["res_fc"])
                out[f"gnn.convs.{i}.attn_l"] = _t(sub["attn_l"])
                out[f"gnn.convs.{i}.attn_r"] = _t(sub["attn_r"])
        elif kind == "linear":
            _linear(out, f"gnn.linears.{i}", sub)
        elif kind == "bn":
            out[f"gnn.bns.{i}.weight"] = _t(sub["scale"])
            out[f"gnn.bns.{i}.bias"] = _t(sub["bias"])
            out[f"gnn.bns.{i}.running_mean"] = _t(stats[name]["mean"])
            out[f"gnn.bns.{i}.running_var"] = _t(stats[name]["var"])
        elif name == "bias_last":
            out["gnn.bias_last.bias"] = _t(sub["bias"])
        else:
            raise ValueError(f"unsupported full-graph param {name!r}")
    return out



def rgat_state_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "out":
            _linear(out, "out", sub)
            continue
        i = int(name.split("_")[1])  # layer_i
        for part, p in sub.items():
            if part == "skip":
                _linear(out, f"layers.{i}.skip", p)
            else:  # etype_t: one GAT layer without its residual branch
                pre = f"layers.{i}.convs.{int(part.split('_')[1])}"
                _linear(out, f"{pre}.fc", p["fc"])
                out[f"{pre}.attn_l"] = _t(p["attn_l"])
                out[f"{pre}.attn_r"] = _t(p["attn_r"])
    return out


def _batch_norm(out, name: str, params: Dict, stats: Dict) -> None:
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])


def _lstm_cell(out, name: str, p: Dict) -> None:
    gates = ("i", "f", "g", "o")
    out[f"{name}.weight_ih"] = _t(np.concatenate([np.asarray(p[f"i{g}"]["kernel"]).T
                                                  for g in gates]))
    out[f"{name}.weight_hh"] = _t(np.concatenate([np.asarray(p[f"h{g}"]["kernel"]).T
                                                  for g in gates]))
    out[f"{name}.bias_hh"] = _t(np.concatenate([p[f"h{g}"]["bias"] for g in gates]))
    out[f"{name}.bias_ih"] = torch.zeros(out[f"{name}.bias_hh"].shape)


def _gnn_node_state(out, pre: str, params: Dict, stats: Dict) -> None:
    for name, sub in params.items():
        if name == "atom_encoder":
            _linear(out, f"{pre}atom_encoder", sub)
        elif name == "vn_init":
            out[f"{pre}vn_init"] = _t(sub)
        elif name.startswith("conv_"):
            c = f"{pre}convs.{int(name.split('_')[1])}"
            for k, table in sub["BondEncoder_0"].items():
                out[f"{c}.bond.tables.{int(k.split('_')[1])}.weight"] = _t(table["embedding"])
            if "eps" in sub:  # GIN
                out[f"{c}.eps"] = _t(sub["eps"])
                _linear(out, f"{c}.lin1", sub["Dense_0"])
                _linear(out, f"{c}.lin2", sub["Dense_1"])
                _batch_norm(out, f"{c}.bn", sub["mlp_bn"], stats[name]["mlp_bn"])
            else:  # GCN
                _linear(out, f"{c}.lin", sub["Dense_0"])
                out[f"{c}.root_emb"] = _t(sub["root_emb"])
        elif name.startswith("bn_"):
            _batch_norm(out, f"{pre}bns.{int(name.split('_')[1])}", sub, stats[name])
        elif name.startswith(("vn_mlp_", "vn_bn_")):
            layer, j = (int(v) for v in name.split("_")[-2:])
            if name.startswith("vn_mlp_"):
                _linear(out, f"{pre}vn_lins.{2 * layer + j}", sub)
            else:
                _batch_norm(out, f"{pre}vn_bns.{2 * layer + j}", sub, stats[name])
        else:
            raise ValueError(f"unsupported GNNNode param {name!r}")


def mol_gnn_state_from_jax(variables: Dict, node_only: bool = False) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    if node_only:
        _gnn_node_state(out, "", params, stats)
        return out
    _gnn_node_state(out, "gnn_node.", params["gnn_node"], stats.get("gnn_node", {}))
    _linear(out, "graph_pred", params["graph_pred"])
    pool = params.get("pool")
    if pool is not None and "gate_bn" in pool:  # attention
        _linear(out, "pool.lin1", pool["Dense_0"])
        _linear(out, "pool.lin2", pool["Dense_1"])
        _batch_norm(out, "pool.bn", pool["gate_bn"], stats["pool"]["gate_bn"])
    elif pool is not None:  # set2set
        for name, cell in pool.items():
            _lstm_cell(out, f"pool.cells.{int(name.split('_')[1])}", cell)
    return out

"""Ranks of the port's multi-process runs.

:func:`spawn` starts W processes with ``torch.multiprocessing``, each one
rank of a process group of ``device``'s backend (gloo on the CPU, NCCL on
the card, one card a rank) that meets at a file store, and runs a function
of the package in each.  The functions live in the package because a
spawned process imports the module that defines its function.
:func:`train_rank` trains the jobs it is given on each rank and saves what
each gave.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import torch

from .mesh import destroy_process_group, init_process_group


def spawn(fn, nprocs: int, device, store: str, *args) -> None:
    """``fn(rank, device, *args)`` in ``nprocs`` spawned ranks of one group
    that meets at the file ``store`` (which must not exist yet); raises if
    a rank fails, or if ``device`` is the card and there are fewer than
    ``nprocs`` cards (NCCL takes one card a rank)."""
    device = str(device)
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"{nprocs} ranks on the card need {nprocs} CUDA devices, "
                           f"found {torch.cuda.device_count()}")
    torch.multiprocessing.spawn(_rank_main, args=(fn, nprocs, device, store, args),
                                nprocs=nprocs, join=True)


def _rank_main(rank: int, fn, world: int, device: str, store: str, args) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_process_group(device, "file://" + store, rank, world, local_rank=rank)
    try:
        fn(rank, device, *args)
    finally:
        destroy_process_group()


def train_rank(rank: int, device: str, jobs: List[Dict[str, Any]], out_dir: str) -> None:
    """Each job on this rank, its results saved as a list to
    ``out_dir/rank{rank}.pt``.  A job is a dict: ``dataset`` and ``cfg``
    (a ``TrainConfig``) of a :class:`SageTrainer` on the default group;
    ``variables``, JAX variables as numpy arrays to load first
    (``convert.load_jax_variables``); ``batches``, host
    ``(seeds, layers, labels)`` for one ``train_step`` each; ``picks``,
    host node ids for one full-neighbour step each (``node_sharded_step``
    under ``--node-shard``); ``epochs``, ``train_epoch`` calls after them;
    with ``infer``, ``infer_full()`` and ``evaluate()`` last.  With
    ``raises`` the trainer is only built, and the ``ValueError`` it raises
    is what the job gives.  A job with ``ring`` is :func:`_ring_job`'s."""
    torch.save([_ring_job(device, **job["ring"]) if "ring" in job else _job(device, **job)
                for job in jobs], os.path.join(out_dir, f"rank{rank}.pt"))


def _ring_job(device, n_data: int, n_node: int, h, layout=None, buckets=None,
              edge_chunk: int = 1 << 22, deg=None, weight=None) -> Dict[str, Any]:
    """The ring SpMM on a ``(n_data, n_node)`` mesh, this rank's block of
    ``h`` (S * block, D) in the storage rows of ``layout`` (ragged) or of
    ``buckets`` (``src_b, dst_b, w_b``, dense): its output and the
    gradient of the sum of its squares; with ``weight``, also
    ``sharded_layerwise_inference`` of two layers of ``tanh(agg @ weight)``
    over the padded degrees ``deg``."""
    from .mesh import make_mesh
    from .node_sharding import dense_shard, ragged_shard, ring_spmm, sharded_layerwise_inference
    mesh = make_mesh(n_data, n_node)
    j = mesh.node_index
    shard = (ragged_shard(layout, j, device, edge_chunk) if layout is not None
             else dense_shard(*buckets, j, device, edge_chunk))
    rows = slice(j * (h.shape[0] // n_node), (j + 1) * (h.shape[0] // n_node))
    hb = torch.tensor(h[rows], device=device, requires_grad=True)
    out = ring_spmm(hb, shard, mesh)
    (out ** 2).sum().backward()
    res = {"out": out.detach().cpu(), "grad": hb.grad.cpu(), "at": (mesh.data_index, j)}
    if weight is not None:
        w = torch.tensor(weight, device=device)
        res["layers"] = sharded_layerwise_inference(
            hb.detach(), shard, mesh, torch.tensor(deg[rows], device=device),
            lambda h, agg, li: torch.tanh(agg @ w), 2).cpu()
    return res


def _job(device, dataset, cfg, variables=None, batches=(), picks=(), epochs: int = 0,
         infer: bool = False, raises: bool = False) -> Dict[str, Any]:
    from ..convert import load_jax_variables
    from ..train import SageTrainer
    if raises:
        try:
            SageTrainer(dataset, cfg, device=device)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    tr = SageTrainer(dataset, cfg, device=device)
    if variables is not None:
        load_jax_variables(tr, variables)
    losses = [float(tr.train_step(s, ls, y)[0]) for s, ls, y in batches]
    for p in picks:
        step = (tr.node_sharded_step(p) if tr.nshard is not None
                else tr.full_neighbor_step(torch.as_tensor(p).to(device)))
        losses.append(float(step[0]))
    stats = [tr.train_epoch(e) for e in range(epochs)]
    inferred = {"logits": tr.infer_full().cpu(), "accs": tr.evaluate()} if infer else {}

    def host(ts):
        return None if ts is None else [t.detach().cpu().clone() for t in ts]

    mesh = tr.node_mesh
    return {"losses": losses, "stats": stats, "step": tr.step, **inferred,
            "mesh": None if mesh is None else (mesh.n_data, mesh.n_node),
            "data_parallel": tr.dp is not None, "fused": tr.fused_sparse,
            "reduced_bytes": 0 if tr.dp is None else tr.dp.reduced_bytes,
            "state": {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()},
            "tt_m": None if tr.tt_opt is None else host(tr.tt_opt.m),
            "tt_v": None if tr.tt_opt is None else host(tr.tt_opt.v),
            "tt_t": None if tr.tt_opt is None else int(tr.tt_opt.count),
            "tt_acc": host(tr.tt_acc), "adam_m": host(tr.opt_state.m),
            "adam_v": host(tr.opt_state.v), "plateau_best": float(tr.plateau.best_value)}

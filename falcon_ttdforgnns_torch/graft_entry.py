"""Entry points of the port's dry run (the counterpart of the JAX
package's ``__graft_entry__.py``).

``entry(device)``            the flagship's forward, GraphSAGE over the TT
                             embedding, at small shapes: ``(fn,
                             example_args)``.
``dryrun_multichip(n, device)``  one full ``--dist`` train step over n
                             ranks, spawned by ``torch.multiprocessing``
                             (gloo on the CPU, NCCL on the card with one card
                             a rank), then a grouped mixed epoch and a
                             puregpu ``--sparse`` epoch (fused Adam split
                             around the all-reduce) on the same ranks; then
                             ``--node-shard``: the dense-bucket ring and the
                             ragged ring against the plain sum, a
                             node-sharded full-neighbour epoch, and at n >= 8
                             the hybrid data x node mesh (a data-parallel
                             step on its data axis, a ring on its node axis,
                             a ``--dist --node-shard`` epoch).

Both run on the card unless the caller passes ``device="cpu"``; with fewer
cards than ranks the dry run raises.

    python -m falcon_ttdforgnns_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch


def _make_model_and_batch(device, num_nodes=6000, feat_dim=32, hidden=64, classes=8,
                          batch=32, fanouts=(3, 4)):
    """The JAX entry's model and batch: SAGE over a rank-(8, 8) TT table of
    a synthetic graph, one sampled batch; on ``device``."""
    from .graph import sample_block, synthetic_dataset
    from .models import SAGE
    ds = synthetic_dataset(num_nodes=num_nodes, avg_degree=8, num_classes=classes,
                           feat_dim=feat_dim, seed=0)
    model = SAGE(num_nodes=ds.num_nodes, in_dim=feat_dim, hidden_dim=hidden,
                 num_classes=classes, num_layers=len(fanouts), use_tt=True,
                 tt_ranks=(8, 8), weight_dist="normal",
                 generator=torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    b = sample_block(ds.graph, rng.integers(0, ds.num_nodes, batch), fanouts, rng)
    seeds = torch.as_tensor(b.seeds).to(device)
    layers = [torch.as_tensor(l).to(device) for l in b.layers]
    labels = torch.as_tensor(ds.labels[b.seeds].astype(np.int64)).to(device)
    return model, seeds, layers, labels


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(seeds, layers)`` is the eval-mode
    forward, (B, classes) logits."""
    from .utils import resolve_device
    model, seeds, layers, _ = _make_model_and_batch(resolve_device(device))

    def fn(seeds, layers):
        return model(seeds, layers, train=False)

    return fn, (seeds, layers)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One ``--dist`` train step over ``n_devices`` spawned ranks, then a
    mixed epoch in groups of 2 steps and a puregpu ``--sparse`` epoch;
    every rank takes the data-parallel step, one rank too.  Raises unless
    every loss is finite and every rank holds the same parameters.
    Returns rank 0's losses."""
    from .parallel.launch import spawn
    from .utils import resolve_device
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_dryrun_rank, n_devices, device, os.path.join(tmp, "store"), tmp)
        res = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=True)
    print(f"dryrun_multichip({n_devices}) on {device}: dp loss={res['dp_loss']:.4f} "
          f"acc={res['dp_acc']:.4f}, dp multi-step loss={res['multi_loss']:.4f}, "
          f"dp x fused-adam sparse loss={res['fused_loss']:.4f} OK")
    print(f"dryrun_multichip({n_devices}): ring-spmm max err {res['ring_err']:.2e}, ragged "
          f"ring-spmm max err {res['ragged_err']:.2e} (memory {res['memory_ratio']:.2f}x E), "
          f"node-sharded full-neighbor train loss={res['nshard_loss']:.4f}"
          + (f", hybrid data x node dp loss={res['hybrid_dp_loss']:.4f}, ring max err "
             f"{res['hybrid_ring_err']:.2e}, TRAIN loss={res['hybrid_loss']:.4f}"
             if n_devices >= 8 else "") + " OK")
    return res


def _dryrun_rank(rank: int, device: str, out_dir: str) -> None:
    import torch.distributed as dist

    from .graph import sample_block, synthetic_dataset
    from .train import SageTrainer, TrainConfig
    n = dist.get_world_size()
    batch = 8 * n
    ds = synthetic_dataset(num_nodes=2000, avg_degree=8, num_classes=4, feat_dim=16, seed=0)
    common = dict(batch_size=batch, fanouts=(2, 3), hidden_dim=32, num_layers=2,
                  tt_ranks=(8, 8), weight_dist="normal", lr=1e-3, dist=True,
                  skip_eval=True, log_every=10**9)
    group = dist.group.WORLD  # given, so that one rank takes the DP step too
    tr = SageTrainer(ds, TrainConfig(**common), device=device, group=group)
    rng = np.random.default_rng(0)
    b = sample_block(ds.graph, rng.integers(0, ds.num_nodes, batch), (2, 3), rng)
    loss, acc = tr.train_step(b.seeds, b.layers, ds.labels[b.seeds].astype(np.int32))
    # the multi-step counterpart: a mixed epoch of 3 batches in groups of 2
    cut = dict(train_idx=ds.train_idx[:3 * batch])
    multi = SageTrainer(dataclasses.replace(ds, **cut),
                        TrainConfig(steps_per_call=2, **common), device=device, group=group)
    m = multi.train_epoch(0)
    fused = SageTrainer(dataclasses.replace(ds, **cut),
                        TrainConfig(mode="puregpu", sparse=True, steps_per_call=2, **common),
                        device=device, group=group)
    f = fused.train_epoch(0)
    if not (multi.step == 4 and fused.fused_sparse and int(fused.tt_opt.count) == fused.step):
        raise AssertionError(f"dry run: {multi.step} grouped steps, fused {fused.fused_sparse}")
    losses = [float(loss), m["loss"], f["loss"]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"dry run: non-finite losses {losses}")
    # the replicas: every rank's parameters must be rank 0's
    for t in (tr, multi, fused):
        flat = torch.cat([p.detach().reshape(-1) for p in t.model.parameters()])
        mine = flat.clone()
        dist.broadcast(flat, src=0)
        if not torch.equal(mine, flat):
            raise AssertionError(f"rank {rank}: parameters differ from rank 0's")
    res = {"dp_loss": losses[0], "dp_acc": float(acc), "multi_loss": losses[1],
           "fused_loss": losses[2], **_node_shard_dryrun(device, group)}
    if not np.isfinite(list(res.values())).all():
        raise AssertionError(f"dry run: non-finite results {res}")
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "rank0.pt"))


def _ring_err(device, mesh, n: int, src, dst, h_nodes, layout=None) -> float:
    """The ring over ``mesh``'s node axis on the dense buckets of (src, dst)
    (or the ragged ``layout``) against the plain sum: the largest
    difference over this rank's rows."""
    from .parallel import dense_shard, partition_edges_by_block, ragged_shard, ring_spmm
    S, j = mesh.n_node, mesh.node_index
    ref = np.zeros_like(h_nodes)
    np.add.at(ref, dst, h_nodes[src])
    if layout is None:
        src_b, dst_b, w_b, block = partition_edges_by_block(src, dst, n, S, pad_multiple=8)
        shard, rows_of = dense_shard(src_b, dst_b, w_b, j, device), np.arange(n)
    else:
        block, shard, rows_of = layout.block, ragged_shard(layout, j, device), layout.row_of
    h, want = (np.zeros((block * S, h_nodes.shape[1]), np.float32) for _ in range(2))
    h[rows_of], want[rows_of] = h_nodes, ref
    mine = slice(j * block, (j + 1) * block)
    out = ring_spmm(torch.as_tensor(h[mine]).to(device), shard, mesh)
    return float(np.abs(out.cpu().numpy() - want[mine]).max())


def _node_shard_dryrun(device, group) -> dict:
    """The node-sharded parts of the dry run (JAX ``__graft_entry__.py:143-214``)."""
    import torch.distributed as dist

    from .graph import rmat_edges, sample_block, synthetic_dataset
    from .parallel import make_mesh, partition_edges_ragged
    from .train import SageTrainer, TrainConfig
    n_dev = dist.get_world_size()
    n = 16 * n_dev
    src, dst = (a.astype(np.int64) for a in rmat_edges(n, 4 * n, seed=1))
    h = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    mesh = make_mesh(1, n_dev, group)
    lay = partition_edges_ragged(src, dst, n, n_dev, chunk=8)
    res = {"ring_err": _ring_err(device, mesh, n, src, dst, h),
           "ragged_err": _ring_err(device, mesh, n, src, dst, h, lay),
           "memory_ratio": lay.memory_ratio}
    if max(res["ring_err"], res["ragged_err"]) > 1e-3:
        raise AssertionError(f"dry run: the ring is off the plain sum {res}")
    nds = synthetic_dataset(num_nodes=64 * n_dev, avg_degree=4, num_classes=4, feat_dim=8,
                            seed=0)
    ncfg = dict(batch_size=16, fanouts=(2, 2), epochs=1, hidden_dim=8, num_layers=2,
                tt_ranks=(2, 2), weight_dist="normal", use_sample=False, node_shard=True,
                skip_eval=True, eval_every=10**9, log_every=10**9)
    ntr = SageTrainer(nds, TrainConfig(**ncfg), device=device, group=group)
    res["nshard_loss"] = ntr.train_epoch(0)["loss"]
    if n_dev >= 8:
        # the hybrid (n/4 x 4) mesh: a data-parallel step on its data axis,
        # the ring on its node axis
        hmesh = make_mesh(n_dev // 4, 4, group)
        ds = synthetic_dataset(num_nodes=2000, avg_degree=8, num_classes=4, feat_dim=16, seed=0)
        dp = SageTrainer(ds, TrainConfig(batch_size=8 * (n_dev // 4), fanouts=(2, 3),
                                         hidden_dim=32, num_layers=2, tt_ranks=(8, 8),
                                         weight_dist="normal", dist=True, skip_eval=True),
                         device=device, group=hmesh.data_group)
        rng = np.random.default_rng(0)
        b = sample_block(ds.graph, rng.integers(0, ds.num_nodes, dp.cfg.batch_size), (2, 3), rng)
        res["hybrid_dp_loss"] = float(dp.train_step(b.seeds, b.layers,
                                                    ds.labels[b.seeds].astype(np.int32))[0])
        res["hybrid_ring_err"] = _ring_err(device, hmesh, n, src, dst, h)
        htr = SageTrainer(nds, TrainConfig(**ncfg, dist=True), device=device, group=group)
        if (htr.node_mesh.n_data, htr.node_mesh.n_node) != (2, n_dev // 2):
            raise AssertionError(f"dry run: a {htr.node_mesh.n_data} x "
                                 f"{htr.node_mesh.n_node} hybrid mesh")
        res["hybrid_loss"] = htr.train_epoch(0)["loss"]
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    fn, args = entry(a.device)
    print("entry forward:", tuple(fn(*args).shape))
    dryrun_multichip(a.n, a.device)

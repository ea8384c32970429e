"""Command-line entry point of the port: sampled GraphSAGE training
(``--model sage``), the sampled GAT through the same trainer (``--model
gat-ns``, the port's own, ``--num-heads`` heads of ``--num-hidden``) and
full-graph GCN/GAT training (``--model gcn|gat``), on CUDA unless
``--device cpu``.

    python -m falcon_ttdforgnns_torch.cli --dataset hard-ogbn-products \
        --sparse --epochs 1
    python -m falcon_ttdforgnns_torch.cli --dataset hard-ogbn-products \
        --mode puregpu --sparse --bf16 --epochs 1
    python -m falcon_ttdforgnns_torch.cli --model gcn --dataset hard-ogbn-arxiv \
        --spmm blocked --epochs 10

Port of ``falcon_ttdforgnns_tpu/cli.py``; ``--run-one`` takes a single
train step (GCN/GAT: one epoch, which is one step) and exits.
``--profile`` traces each ``fit`` with ``torch.profiler`` into
``--profile-dir`` (a Chrome trace).  After training, ``--save-pred`` writes
``pred_{model}_{dataset}.npz`` (``pred``, ``logits``) of the layer-wise
inference, ``--store-emb`` the TT table as
``emb_{init}_tt{r}_part{partition}.npy`` and ``--save-model`` a checkpoint
(``extra`` holds the best accuracies), all into ``--ckpt-dir``;
``--access-counts`` logs the access skew, and ``--plot`` draws its CDF
into ``--log-dir`` where matplotlib is installed.  ``--autotune`` searches
the TT ranks (``utils/tuner.py``): one epoch a candidate, objective the
inverse of its samples/s, then prints ``{"best_ranks": ..., "objective":
...}``.  :func:`main` parses the flags, loads and reorders the dataset
(:func:`load_dataset`) and hands both to :func:`run`.

``--dist`` trains data-parallel, and ``--node-shard`` shards the node space
(with ``--dist --full-neighbor`` the hybrid data x node split), over a
``torch.distributed`` process group of one rank per card (``parallel/``),
which :func:`main` sets up under
``--multihost`` (``torchrun``'s environment, or JAX's
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``) or wherever
a launcher's ``WORLD_SIZE`` is above 1, and tears down at the end:

    python -m torch.distributed.run --nproc-per-node 8 \
        -m falcon_ttdforgnns_torch.cli --dist --mode puregpu --sparse --bf16

Rank 0 alone logs and writes predictions, tables and checkpoints; the other
ranks wait for it at a barrier.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import time

import numpy as np
import torch


def main(argv=None):
    import torch.distributed as dist

    from .parallel import destroy_process_group, init_multihost, rank
    from .utils.config import parse_args, apply_preset
    from .utils.logger import get_logger

    args = apply_preset(parse_args(argv))
    # the group first, so that rank 0 alone logs; one set up by the caller stays
    owned = not dist.is_initialized() and (
        args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if owned:
        init_multihost(device=args.device)
    try:
        r = rank()
        logger = (get_logger("falcon_torch", args.log_dir) if r == 0 else
                  get_logger(f"falcon_torch.rank{r}", level=logging.ERROR))
        if dist.is_initialized():
            logger.info(f"multihost: process group backend {dist.get_backend()}, world size "
                        f"{dist.get_world_size()}, rank {r}")
        elif args.multihost:
            logger.info("multihost: one process, no process group")
        return run(args, load_dataset(args, logger), logger)
    finally:
        if owned:
            destroy_process_group()


def load_dataset(args, logger):
    """``--dataset`` (synthetic at ``--synthetic-scale`` where its files are
    absent), relabelled by ``--partition``."""
    from .graph import get_dataset, reorder_permutation_cached
    t0 = time.time()
    ds = get_dataset(args.dataset, synthetic_scale=args.synthetic_scale,
                     seed=args.seed, official_split=args.official_split)
    logger.info(f"dataset {ds.name}: {ds.num_nodes} nodes, "
                f"{ds.graph.num_edges} edges ({time.time() - t0:.1f}s)")
    # --partition: 0 random, >0 k-way, -1 recursive, -2 RCMK, -3 degree,
    # -4 louvain; cached on disk (./reorder_cache) keyed on the graph and flags
    t0 = time.time()
    perm = reorder_permutation_cached(ds.graph, args.partition, levels=args.p_shapes,
                                      seed=args.seed)
    if perm is not None:
        ds = ds.permute(perm)
        logger.info(f"reorder partition={args.partition}: {time.time() - t0:.1f}s")
    return ds


def run(args, ds, logger):
    """Train on ``ds`` as the flags say (``--n-runs`` seeds, or the
    ``--autotune`` search), then what the flags ask after each fit.
    Returns the best accuracies (None for ``--autotune``, whose result is
    printed)."""
    from .parallel import rank, world_size
    from .train import FullGraphConfig, FullGraphTrainer, SageTrainer, TrainConfig
    from .train.checkpoint import save_checkpoint
    from .utils import metrics as M

    if args.emb_name == "dense":
        args.use_tt = False
    if args.emb_name == "eff":
        logger.info("--emb-name eff is the tt lookup here: on the card tt_fwd and "
                    "tt_grads already take each id prefix's chain once per run of "
                    "sorted ids (Efficient_TT's dedup); the CPU runs the plain lookup")
    precomputed = _maybe_init_cores(args, ds, logger)

    def run_once(tt_ranks):
        weight_dist = args.init if args.init in (
            "normal", "uniform", "naive-uniform", "approx-normal",
            "approx-uniform") else "approx-normal"
        if args.model in ("gcn", "gat"):
            fcfg = FullGraphConfig(
                model=args.model, epochs=args.epochs, lr=args.lr, weight_decay=args.wd,
                dropout=args.dropout, hidden_dim=args.num_hidden,
                num_layers=args.num_layers, num_heads=args.num_heads,
                use_linear=args.use_linear, use_labels=args.use_labels,
                use_tt=args.use_tt, tt_ranks=tuple(tt_ranks),
                p_shapes=tuple(args.p_shapes) if args.p_shapes else None,
                q_shapes=tuple(args.q_shapes) if args.q_shapes else None,
                weight_dist=weight_dist, spmm=args.spmm,  # the trainer rejects pallas, gat+blocked
                eval_every=args.eval_every, seed=args.seed)
            trainer = FullGraphTrainer(ds, fcfg, logger=logger,
                                       precomputed_cores=precomputed, device=args.device)
            if args.run_one:
                stats = trainer.train_epoch(0)
                logger.info(f"run-one: {stats}")
                return stats
            return after_fit(trainer, traced_fit(trainer))
        cfg = TrainConfig(
            batch_size=args.batch, fanouts=tuple(args.fan_out),
            epochs=args.epochs, lr=args.lr, dropout=args.dropout,
            weight_decay=args.wd,
            hidden_dim=args.num_hidden, num_layers=args.num_layers,
            use_tt=args.use_tt, tt_ranks=tuple(tt_ranks),
            p_shapes=tuple(args.p_shapes) if args.p_shapes else None,
            q_shapes=tuple(args.q_shapes) if args.q_shapes else None,
            weight_dist=weight_dist,
            cache_size=args.cache_size if args.use_cached else 0,
            tt_optimizer=args.tt_optimizer,
            plateau_patience=args.plateau_patience,
            plateau_rtol=args.plateau_rtol, plateau_smooth=args.plateau_smooth,
            sparse=args.sparse, batch_count=args.batch_count, spmm=args.spmm,
            mode=args.mode, sampler=args.sampler, table_width=args.table_width,
            rng_impl=args.rng_impl, num_workers=args.num_workers,
            use_sample=args.use_sample,
            node_shard=args.node_shard, steps_per_call=args.steps_per_call,
            # the model counts only without TT (make_embed_layer's order); the
            # host loader counts either way, as the JAX loader always does
            access_counts=args.access_counts,
            skip_eval=args.skip_eval, eval_sampled=args.eval_sampled,
            eval_sample_max=args.eval_sample_max, eval_every=args.eval_every,
            log_every=args.log_every, seed=args.seed, dist=args.dist,
            num_chips=args.num_chips, data_shards=args.data_shards,
            bf16=args.bf16, bf16_tower=args.bf16_tower,
            bf16_kernel=args.bf16_kernel, bf16_mean_f32=args.bf16_mean_f32,
            bf16_sr=args.bf16_sr, bf16_f32_head=args.bf16_f32_head,
            bf16_f32_first=args.bf16_f32_first,
            model="gat" if args.model == "gat-ns" else "sage", num_heads=args.num_heads)
        trainer = SageTrainer(ds, cfg, logger=logger, precomputed_cores=precomputed,
                              device=args.device)
        if args.run_one:
            batch = next(iter(trainer.loader))
            t1 = time.perf_counter()
            loss, _ = trainer.train_step(batch.seeds, batch.layers, batch.labels)
            loss = float(loss)  # waits for the step
            stats = {"loss": loss, "step_time": time.perf_counter() - t1}
            logger.info(f"run-one: {stats}")
            return stats
        return after_fit(trainer, traced_fit(trainer))

    def traced_fit(trainer):
        with M.profile_trace(args.profile_dir if args.profile else None):
            return trainer.fit()

    def after_fit(trainer, result):
        # --dist: rank 0 writes, the others wait for it; the node-sharded
        # inference is every rank's
        pred = args.save_pred and not args.skip_eval and hasattr(trainer, "infer_full")
        logits = (trainer.infer_full() if pred and (
            rank() == 0 or getattr(trainer, "node_mesh", None) is not None) else None)
        if rank() == 0:
            write_outputs(trainer, result, logits)
        if world_size() > 1:
            torch.distributed.barrier()
        return result

    def write_outputs(trainer, result, logits):
        logger.info(f"best: {result['best']}")
        if logits is not None:
            # the per-node prediction dump (sage_dgl_partition.py:373-374)
            logits = logits.float().cpu().numpy()
            os.makedirs(args.ckpt_dir, exist_ok=True)
            np.savez(os.path.join(args.ckpt_dir, f"pred_{args.model}_{args.dataset}.npz"),
                     pred=logits.argmax(-1), logits=logits)
            logger.info("saved predictions")
        if args.store_emb and args.use_tt:
            # the final table (gcn_gat_partition.py:341-344), through the lookup
            path = os.path.join(args.ckpt_dir, f"emb_{args.init}_tt{args.tt_rank[0]}"
                                               f"_part{args.partition}.npy")
            store_embedding(trainer, ds.num_nodes, path)
            logger.info(f"stored embedding table {path}")
        if (args.access_counts or args.plot) and hasattr(trainer, "access_count_stats"):
            stats = trainer.access_count_stats()
            if stats:
                logger.info(f"access skew (top-x% of rows -> % of accesses): "
                            f"{stats['percentages']}")
                if args.plot:
                    os.makedirs(args.log_dir, exist_ok=True)
                    path = os.path.join(args.log_dir, "access_cdf.png")
                    drawn = M.plot_access_cdf(stats["counts"], path)
                    logger.info(f"access CDF: {path if drawn else 'not drawn (no matplotlib)'}")
        logger.info(f"embed params MB: "
                    f"{M.model_size_mb(trainer.model.embed.parameters()):.2f}")
        if args.save_model:
            path = save_checkpoint(args.ckpt_dir, trainer_step(trainer),
                                   *trainer.checkpoint_state(), {"best": result["best"]})
            logger.info(f"checkpoint: {path}")

    if args.autotune:
        autotune(args, run_once, logger)
        return None
    best = None
    base_seed = args.seed
    for i in range(args.n_runs):
        args.seed = base_seed + i
        result = run_once(args.tt_rank)
        if "best" in result and (best is None
                                 or result["best"]["test_acc"] > best["test_acc"]):
            best = result["best"]
    if best and rank() == 0:
        print(json.dumps({"best": best}))
    return best


@torch.no_grad()
def store_embedding(trainer, num_nodes: int, path: str, chunk: int = 65536) -> np.ndarray:
    """The (num_nodes, D) f32 feature table, materialised ``chunk`` ids at
    a time through the model's lookup (``tt_fwd`` on the card), saved to
    ``path`` (``np.save``) and returned."""
    dev = next(trainer.model.parameters()).device
    emb = np.concatenate([trainer.model.materialize_features(torch.arange(
        s, min(s + chunk, num_nodes), dtype=torch.int32, device=dev)).float().cpu().numpy()
        for s in range(0, num_nodes, chunk)])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, emb)
    return emb


def autotune(args, run_once, logger):
    """The TT-rank search (``tuning_SAGE.py:213-240``): ``--tune-budget``
    candidates of one epoch each, the objective 1 / samples_per_s of the
    epoch, each trainer freed before the next (its device memory and the
    kernels' kept argument sets), so peak memory does not grow from
    candidate to candidate.  Logs each candidate's ranks, samples/s and
    peak device memory, and prints the best as one JSON line."""
    from .ops import tt_kernels
    from .parallel import rank
    from .utils import metrics as M
    from .utils.tuner import tune_tt_rank

    def tput_of(ranks):
        epochs, args.epochs = args.epochs, 1
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        try:
            res = run_once(ranks)
        finally:
            args.epochs = epochs
            gc.collect()
            tt_kernels.clear_launch_args()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        hist = res["history"][-1] if isinstance(res, dict) and "history" in res else res
        tput = hist.get("samples_per_s", hist.get("edges_per_s", 1.0))
        peak = {d: m["peak_bytes_mb"] for d, m in M.device_memory_stats().items()}
        logger.info(f"autotune: ranks {tuple(ranks)}: {tput:.1f} samples/s, "
                    f"peak device memory MB {peak}")
        return tput

    tr = tune_tt_rank(tput_of, budget=args.tune_budget, seed=args.seed)
    if rank() == 0:
        print(json.dumps({"best_ranks": tr.best_params, "objective": tr.best_value}))
    return tr


def trainer_step(trainer) -> int:
    return getattr(trainer, "step", 0)


def _maybe_init_cores(args, ds, logger):
    """ortho/eigen/dortho core init (gnn_model.py:129-178)."""
    if not args.use_tt or args.init not in ("ortho", "eigen", "dortho"):
        return None
    from .ops import make_tt_shapes, tt_init

    shapes = make_tt_shapes(ds.num_nodes, ds.feat_dim, tuple(args.tt_rank),
                            tuple(args.p_shapes) if args.p_shapes else None,
                            tuple(args.q_shapes) if args.q_shapes else None)
    t0 = time.time()
    if args.init == "ortho":
        cores = tt_init.init_ortho(shapes, seed=args.seed)
    elif args.init == "dortho":
        cores = tt_init.init_dortho(shapes, seed=args.seed)
    else:
        cores = tt_init.init_eigen(shapes, ds.graph.indptr, ds.graph.indices,
                                   seed=args.seed)
    logger.info(f"init={args.init} cores in {time.time() - t0:.1f}s")
    return tuple(cores)


if __name__ == "__main__":
    main()

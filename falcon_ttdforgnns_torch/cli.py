"""Command-line entry point of the port: sampled GraphSAGE training
(``--model sage``), on CUDA unless ``--device cpu``.

    python -m falcon_ttdforgnns_torch.cli --dataset hard-ogbn-products \
        --sparse --epochs 1

Port of ``falcon_ttdforgnns_tpu/cli.py`` for ``--model sage`` with
sampling; ``--run-one`` takes a single train step and exits.
"""

from __future__ import annotations

import json
import time


def main(argv=None):
    from .utils.config import parse_args, apply_preset
    from .utils.logger import get_logger

    args = apply_preset(parse_args(argv))
    logger = get_logger("falcon_torch", args.log_dir)
    if args.model != "sage":
        raise NotImplementedError(f"--model {args.model} is not ported yet "
                                  f"(ROADMAP A14)")
    for flag in ("multihost", "autotune", "profile", "save_model", "save_pred",
                 "store_emb", "plot"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not "
                                      f"ported yet (ROADMAP A10/A17)")
    if args.emb_name == "dense":
        args.use_tt = False

    from .graph import get_dataset, reorder_permutation
    from .train import SageTrainer, TrainConfig

    t0 = time.time()
    ds = get_dataset(args.dataset, synthetic_scale=args.synthetic_scale,
                     seed=args.seed, official_split=args.official_split)
    logger.info(f"dataset {ds.name}: {ds.num_nodes} nodes, "
                f"{ds.graph.num_edges} edges ({time.time() - t0:.1f}s)")
    t0 = time.time()
    ds = ds.permute(reorder_permutation(ds.graph, args.partition,
                                        levels=args.p_shapes, seed=args.seed))
    logger.info(f"reorder partition={args.partition}: {time.time() - t0:.1f}s")
    precomputed = _maybe_init_cores(args, ds, logger)

    def run_once(tt_ranks):
        cfg = TrainConfig(
            batch_size=args.batch, fanouts=tuple(args.fan_out),
            epochs=args.epochs, lr=args.lr, dropout=args.dropout,
            weight_decay=args.wd,
            hidden_dim=args.num_hidden, num_layers=args.num_layers,
            use_tt=args.use_tt, tt_ranks=tuple(tt_ranks),
            p_shapes=tuple(args.p_shapes) if args.p_shapes else None,
            q_shapes=tuple(args.q_shapes) if args.q_shapes else None,
            weight_dist=args.init if args.init in (
                "normal", "uniform", "naive-uniform", "approx-normal",
                "approx-uniform") else "approx-normal",
            cache_size=args.cache_size if args.use_cached else 0,
            tt_optimizer=args.tt_optimizer,
            plateau_patience=args.plateau_patience,
            plateau_rtol=args.plateau_rtol, plateau_smooth=args.plateau_smooth,
            sparse=args.sparse, batch_count=args.batch_count, spmm=args.spmm,
            mode=args.mode, sampler=args.sampler, table_width=args.table_width,
            rng_impl=args.rng_impl, num_workers=args.num_workers,
            use_sample=args.use_sample, grouped=(args.emb_name == "eff"),
            node_shard=args.node_shard, steps_per_call=args.steps_per_call,
            access_counts=args.access_counts and not args.use_tt,
            skip_eval=args.skip_eval, eval_sampled=args.eval_sampled,
            eval_sample_max=args.eval_sample_max, eval_every=args.eval_every,
            log_every=args.log_every, seed=args.seed, dist=args.dist,
            num_chips=args.num_chips, data_shards=args.data_shards,
            bf16=args.bf16, bf16_tower=args.bf16_tower,
            bf16_kernel=args.bf16_kernel, bf16_mean_f32=args.bf16_mean_f32,
            bf16_sr=args.bf16_sr, bf16_f32_head=args.bf16_f32_head,
            bf16_f32_first=args.bf16_f32_first)
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
        result = trainer.fit()
        logger.info(f"best: {result['best']}")
        return result

    best = None
    base_seed = args.seed
    for run in range(args.n_runs):
        args.seed = base_seed + run
        result = run_once(args.tt_rank)
        if "best" in result and (best is None
                                 or result["best"]["test_acc"] > best["test_acc"]):
            best = result["best"]
    if best:
        print(json.dumps({"best": best}))


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

"""The flag system — parity with the reference's single shared
``parse_args`` (`tt_utils.py:17-85`), which every entry script consumes.
Defaults mirror the reference (batch 1024, fan-out 5,10,15, tt-rank 16,16,
p-shapes 125,140,140, q-shapes 5,5,4, hidden 256, 3 layers).

A copy of ``falcon_ttdforgnns_tpu/utils/config.py`` with ``--device``
defaulting to ``cuda``.  Every flag of the JAX CLI parses; the trainer
raises ``NotImplementedError`` for the values this port does not run yet.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x != ""]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TT-embedding GNN training (PyTorch/CUDA)")

    # general (tt_utils.py:19-43)
    g = p.add_argument_group("general")
    g.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    # gat-ns, the port's own: the sampled GAT through SageTrainer (models/gat_ns.py)
    g.add_argument("--model", type=str, default="sage", choices=["sage", "gcn", "gat", "gat-ns"])
    g.add_argument("--dataset", type=str, default="ogbn-products")
    g.add_argument("--epochs", type=int, default=2)
    g.add_argument("--lr", type=float, default=0.003)
    g.add_argument("--plateau-patience", type=int, default=-1,
                   help="ReduceLROnPlateau patience in steps "
                        "(sage_dgl_partition.py:107); 0 disables the "
                        "scheduler; -1 = auto: 800 in f32, DISABLED "
                        "under a bf16 tower (whose loss noise the "
                        "ratchet reads as a plateau, halving lr into "
                        "the noise floor — the r4 bf16 accuracy ceiling)")
    g.add_argument("--plateau-rtol", type=float, default=1e-4,
                   help="plateau improvement threshold (torch threshold "
                        "parity)")
    g.add_argument("--plateau-smooth", type=float, default=0.0,
                   help="EMA smoothing of the plateau's loss input "
                        "(manual knob; 0 = raw torch parity)")
    g.add_argument("--dropout", type=float, default=0.5)
    g.add_argument("--wd", type=float, default=0.0, help="weight decay")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--n-runs", type=int, default=1)

    # dataloader (tt_utils.py:44-53)
    d = p.add_argument_group("dataloader")
    d.add_argument("--batch", type=int, default=1024)
    d.add_argument("--fan-out", type=_int_list, default=[5, 10, 15])
    d.add_argument("--use-sample", action="store_true", default=True)
    d.add_argument("--full-neighbor", dest="use_sample", action="store_false",
                   help="full-neighbor training instead of sampling")
    d.add_argument("--num-workers", type=int, default=4)
    d.add_argument("--mode", type=str, default="mixed", choices=["mixed", "puregpu"],
                   help="mixed: graph in host RAM, batches on device "
                        "(the reference's UVA analog); puregpu: graph on device")
    d.add_argument("--sampler", type=str, default="csr",
                   choices=["csr", "table"],
                   help="puregpu neighbor sampling: per-edge CSR gathers, or "
                        "a prebuilt (N, table-width) iid-uniform neighbor "
                        "table (fewer HBM transactions per hop)")
    d.add_argument("--table-width", type=int, default=32,
                   help="slots per node in the --sampler table")
    d.add_argument("--rng-impl", type=str, default="threefry",
                   choices=["threefry", "rbg"],
                   help="in-step PRNG of the JAX package: threefry or the "
                        "TPU's hardware rbg; the port accepts both and draws "
                        "from torch's Philox generator")
    d.add_argument("--synthetic-scale", type=float, default=1.0,
                   help="shrink factor for synthetic fallback datasets")
    d.add_argument("--official-split", action="store_true",
                   help="use the dataset's OFFICIAL OGB split sizes on the "
                        "synthetic stand-in (matched per-epoch work vs the "
                        "reference; default is a 60/20/20 split)")

    # distributed
    dist = p.add_argument_group("distributed")
    dist.add_argument("--dist", action="store_true", help="data-parallel over the device mesh")
    dist.add_argument("--num-chips", type=int, default=-1,
                      help="#devices for the data axis (-1 = all)")
    dist.add_argument("--node-shard", action="store_true",
                      help="node-space-sharded layer-wise inference over a "
                           "'node' mesh axis (ring SpMM; papers100M scale-out)")
    dist.add_argument("--data-shards", type=int, default=-1,
                      help="with --dist --node-shard: width of the 'data' "
                           "axis of the hybrid data x node mesh (-1 = one "
                           "group per host, or 2 on a single host)")
    dist.add_argument("--multihost", action="store_true",
                      help="multi-host bootstrap (not ported yet)")
    dist.add_argument("--steps-per-call", type=int, default=8,
                      help="optimizer steps per dispatch in the JAX package; "
                           "the eager port runs one step per call, and under "
                           "--mode puregpu copies the seeds and labels of this "
                           "many batches to the device at once")

    # GNN (tt_utils.py:44-48)
    n = p.add_argument_group("gnn")
    n.add_argument("--num-hidden", type=int, default=256)
    n.add_argument("--num-layers", type=int, default=3)
    n.add_argument("--num-heads", type=int, default=3)
    n.add_argument("--use-linear", action="store_true")
    n.add_argument("--use-labels", action="store_true",
                   help="label-as-feature trick (gcn_gat_partition.py:71-76)")

    # TT embedding (tt_utils.py:49-66)
    t = p.add_argument_group("tt")
    t.add_argument("--bf16", action="store_true",
                   help="SAGE: bf16 activations end-to-end — the fused "
                        "lookup kernel stores h_all in bf16, the tower and "
                        "fanout means run bf16, the backward kernel "
                        "consumes the bf16 cotangent natively (params/"
                        "cores/grads stay f32). Scope: sampled-SAGE "
                        "trainers only; full-graph gcn/gat run f32")
    t.add_argument("--bf16-tower", action="store_true",
                   help="precision-attribution half of --bf16: conv tower "
                        "activations bf16, kernel I/O stays f32")
    t.add_argument("--bf16-kernel", action="store_true",
                   help="precision-attribution half of --bf16: fused-kernel "
                        "h_all/d_h in bf16, tower stays f32")
    t.add_argument("--bf16-mean-f32", action="store_true",
                   help="with a bf16 tower: accumulate the fanout means in "
                        "f32 (fused reduce accumulator, bf16 output) — "
                        "convergence-lag fix candidate for the tower half")
    t.add_argument("--bf16-sr", action="store_true",
                   help="with bf16 kernel I/O: stochastic rounding on the "
                        "h_all store (in-VMEM hashed dither, zero extra "
                        "HBM bytes) — convergence-lag fix candidate for "
                        "the kernel half")
    t.add_argument("--bf16-f32-head", action="store_true",
                   help="with a bf16 tower: run the LAST conv (logits "
                        "head) in f32 — tower-ceiling mechanism probe, "
                        "~zero HBM cost (the head level is (B,1,H))")
    t.add_argument("--bf16-f32-first", action="store_true",
                   help="with a bf16 tower: run the FIRST conv in f32 — "
                        "tower-ceiling mechanism probe (pays the f32 "
                        "input-promotion copies on the biggest levels)")
    t.add_argument("--use-tt", action="store_true", default=True)
    t.add_argument("--no-tt", dest="use_tt", action="store_false")
    t.add_argument("--tt-rank", type=_int_list, default=[16, 16])
    t.add_argument("--p-shapes", type=_int_list, default=None)
    t.add_argument("--q-shapes", type=_int_list, default=None)
    t.add_argument("--init", type=str, default="approx-normal",
                   choices=["normal", "uniform", "naive-uniform", "approx-normal",
                            "approx-uniform", "ortho", "eigen", "dortho"])
    t.add_argument("--partition", type=int, default=0,
                   help=">0 k-way partition reorder; 0 random; -1 recursive "
                        "multilevel (TT-shape matched); -2 RCMK; -3 degree; "
                        "-4 louvain (graphloader.py:399-454 semantics)")
    t.add_argument("--emb-name", type=str, default="tt",
                   choices=["tt", "eff", "dense"],
                   help="embedding impl: tt (FBTT-analog fused lookup), "
                        "eff (Efficient_TT grouped prefix-dedup lookup; the "
                        "port's tt kernels already group by prefix, so an alias), "
                        "dense (no TT)")
    t.add_argument("--sparse", action="store_true",
                   help="fused in-kernel TT-core updates (one Pallas pass: "
                        "recompute chain + backward + optimizer).  Default "
                        "core update is fused Adam with the plateau lr "
                        "schedule coupled in — the adaptive update hard "
                        "graphs require; --tt-optimizer sgd gives the "
                        "reference's EXACT_SGD fixed-lr semantics")
    t.add_argument("--tt-optimizer", type=str, default="adam",
                   choices=["adam", "sgd", "adagrad", "rowwise_adagrad"],
                   help="TT-core optimizer routing (OptimType parity: "
                        "tt_adagrad_backward cu:721-754, EXACT_ROWWISE_"
                        "ADAGRAD); under --sparse each routes to its fused "
                        "kernel (adam the default and the one that "
                        "converges on hard graphs; sgd/adagrad are "
                        "fixed-lr reference-parity modes)")
    t.add_argument("--batch-count", type=int, default=65536,
                   help="lookup chunk size (VMEM budget knob, cu:1027 analog)")
    t.add_argument("--spmm", type=str, default="xla",
                   choices=["xla", "pallas", "blocked"],
                   help="full-graph aggregation backend for eval: chunked "
                        "XLA gather+segment-sum (measured fastest on v5e), "
                        "the tiled segment-matmul Pallas kernel, or the "
                        "window-blocked VMEM-gather kernel "
                        "(ops/spmm_blocked.py)")

    # cache (tt_utils.py:60-63)
    c = p.add_argument_group("cache")
    c.add_argument("--use-cached", action="store_true")
    c.add_argument("--cache-size", type=int, default=0)
    c.add_argument("--access-counts", action="store_true")

    # logging / eval (tt_utils.py:67-85)
    e = p.add_argument_group("extras")
    e.add_argument("--log-every", type=int, default=20)
    e.add_argument("--eval-every", type=int, default=1)
    e.add_argument("--skip-eval", action="store_true")
    e.add_argument("--eval-sampled", action="store_true",
                   help="held-out accuracy via the sampled fanout forward "
                        "instead of full layer-wise inference — the only "
                        "eval that fits one chip at papers100M scale "
                        "(full inference materializes (N, D) f32 = 28 GB "
                        "at 55.5M nodes); big splits are subsampled")
    e.add_argument("--eval-sample-max", type=int, default=131072,
                   help="per-split seed cap under --eval-sampled")
    e.add_argument("--save-model", action="store_true")
    e.add_argument("--save-pred", action="store_true")
    e.add_argument("--store-emb", action="store_true")
    e.add_argument("--ckpt-dir", type=str, default="./checkpoints")
    e.add_argument("--log-dir", type=str, default="./logs")
    e.add_argument("--plot", action="store_true")
    e.add_argument("--run-one", action="store_true", help="one fwd/bwd step then exit")
    e.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of each fit into --profile-dir")
    e.add_argument("--profile-dir", type=str, default="./profiles")

    # autotuning (tuning_SAGE.py parity)
    a = p.add_argument_group("autotune")
    a.add_argument("--autotune", action="store_true")
    a.add_argument("--tune-budget", type=int, default=20)

    return p.parse_args(argv)


# Dataset presets (run_script.sh:135-150, 408-453 shape/rank configs)
DATASET_PRESETS = {
    "ogbn-arxiv": dict(p_shapes=[50, 60, 60], q_shapes=[8, 4, 4]),
    # q-shapes 5,5,4 = the reference default (`tt_utils.py:57`): cores pair
    # as (125,5),(140,5),(140,4)
    "ogbn-products": dict(p_shapes=[125, 140, 140], q_shapes=[5, 5, 4]),
    "ogbn-papers100M": dict(p_shapes=[400, 500, 600], q_shapes=[4, 4, 8]),
}


def apply_preset(args: argparse.Namespace) -> argparse.Namespace:
    # hard-<name> (planted-partition at <name>'s scale) shares <name>'s
    # TT-shape preset — same node count, same factorization.
    base = args.dataset[5:] if args.dataset.startswith("hard-") else args.dataset
    preset = DATASET_PRESETS.get(base)
    if preset:
        if args.p_shapes is None:
            args.p_shapes = preset["p_shapes"]
        if args.q_shapes is None:
            args.q_shapes = preset["q_shapes"]
    return args

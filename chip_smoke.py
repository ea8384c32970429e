#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (falcon_ttdforgnns_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels and the native host runtime from csrc/ (one
   nvcc per CUDA source and the host compiler for falcon_native.cpp, all
   at once) and times the build; profiles one B8 call on a random graph
   (one memset and one kernel, nothing else); builds the full-size
   hard-ogbn-products graph (the native CSR builder); after step 5 and
   the flagship's phases of step 6, starts its --partition 128 (the native
   k-way partitioner) in a thread, and --partition -1 and -4 on the
   full-size hard-ogbn-arxiv graph in a process, beside step 4, which
   times nothing;
3. holds each TT kernel (and each variant: bf16 store, stochastically
   rounded store, bf16 d_out, SGD, adagrad, rowwise adagrad) against its
   plain PyTorch version at the main path's shapes (ogbn-products TT
   shapes, 937,984 ids per step from a seeded zipf draw) and at small 2-
   and 4-core shapes, and times kernel, plain version and, where one
   exists, the PyTorch library call for the same function; for the
   launch-sized updates (Adam, SGD, adagrad) also the device time per call
   from torch.profiler beside the loop time, for kernel and library call;
   for tt_fwd and tt_grads the sort of their ids apart, the distinct ids
   and prefix runs that set their bounds and the pieces and segments of
   their walks; holds the lookup's three stores against their plain
   versions at 2 and 4 cores on ids whose hot id spans many chunks of 1 and
   3 positions; times the host's two ways to read the current stream;
4. checks the train step on the card against the same step on the CPU
   (plain versions) on a tiny graph, for f32 --sparse, f32 without it,
   --bf16 --sparse, --bf16 --bf16-sr --sparse and each --tt-optimizer, and
   3 full-graph steps of GCN (--spmm xla and blocked) and GAT; and 3
   --mode puregpu steps sampled on the card (--sampler csr in f32, --sampler
   table under --bf16), whose layers the CPU trainer's steps take; and
   (d) the cache's lifecycle (3 warmup steps, the populate from the host
   counts, 3 cached steps) in f32 and under --bf16: the same ids cached,
   the parameters within tolerance;
5. trains full-graph GCN (--spmm xla, --spmm blocked) and GAT at full
   width (3 layers x 256, GAT 3 heads) on the full-size hard-ogbn-arxiv
   graph, 3 steps each with the launch counters zeroed before and read
   after, then evaluate(); the blocked losses are held to the xla ones;
6. (a) the orderings: host seconds of --partition 0, -2 (RCMK), -3
   (degree) and 128 at products and of -1, -4 at arxiv; one flagship
   batch's ids relabelled by each ordering, and uniform random ids beside
   them: distinct ids, prefix runs, tt_fwd and tt_grads ms.  Then trains
   the full-width SAGE 3x256 on the full-size hard-ogbn-products
   graph.  The flagship, --mode puregpu --bf16 --sparse (the CSR on the
   card, sampling in the step, bf16 kernel I/O, fused Adam): an epoch of 5
   steps through train_epoch with the launch counters zeroed before and
   read after (and the update's argument-cache misses: at most the first
   step's; the sorts: one a step); each step's device-sampled ids' walk
   counts and the bounds of tt_fwd and tt_grads, and the lookup's three
   stores held against their plain versions on those ids; a profiled epoch
   (device busy against wall, the sampler's device ms apart from the
   step's, one aten::sort a step, one host-to-device copy, of the seeds and
   labels, for the epoch); a timed epoch (seeds/s); beside it, the
   --mode mixed flagship's 5 steps sampled on the host as train_epoch
   does, counted; tt_fwd[bf16] and tt_grads[bf16] on the main path's ids
   at 32, 64 and 128 sorted positions a warp; 2 steps of --sampler table
   --table-width 32 (the table's host build and device memory, seeds/s);
   the samplers on the card at products (every id in range, 256 seeds'
   ids each an in-neighbour, 4-sigma binomial uniformity of the
   highest-degree node's draws); then, each with the counters zeroed
   before and read after, 2 steps each of --bf16 --bf16-sr --sparse,
   --sparse --tt-optimizer sgd|adagrad (host-sampled) and
   rowwise_adagrad (--mode puregpu), 2 f32 --sparse steps, 2 f32 steps
   without --sparse (TTLookup's backward kernel), and full-graph
   evaluate() in f32 and under bf16.  (b) The slice's path, the README's
   final-p (--partition 128 --use-cached --cache-size 100000, f32 routed
   Adam, --mode mixed through the native sampler; the native sampler's ms
   a batch beside the numpy sampler's), counted from its warmup epoch to
   its evaluate(): 40 warmup steps counted by the host loader, the
   populate (its ids the top 100,000 of the counts, its rows held to the
   plain chain; the warmup steps' host time cut into sampling, access
   counting and the step's call), 10 cached steps on fresh seeds with
   their hit shares,
   evaluate(); then the same warmup and cached batches without the cache,
   ms a step against the cached.  (c) The puregpu flagship with the cache
   (--use-cached --cache-size 100000): a warmup epoch counted on the card,
   the populate from those counts, a cached epoch, each counted.  (e) The
   README's baseline preset (--no-tt: the dense 2,449,029 x 100 f32 table,
   routed Adam): 5 --mode mixed steps, a puregpu epoch of 5 steps counted,
   profiled and timed, evaluate(); the TT flagship in f32 on the same
   puregpu batches; ms a step, seeds/s, device busy, peak memory and the
   bytes of parameters and optimizer state of each.  (f) --no-tt and
   --full-neighbor steps on the tiny graph, card vs CPU; then
   --full-neighbor at products (f32, routed Adam, batch 1024): 3 steps
   counted (tt_fwd over all 2,449,029 ids and tt_grads once each a step),
   one profiled, both kernels at this shape against their plain versions
   and bounds, evaluate().  (g) The bf16 fan-out mean's two kernels (the
   port's own, no TPU kernel's) bit for bit against their plain versions
   on the flagship's six level shapes, timed.  (h) Checkpoints: the puregpu
   flagship after an epoch and final-p after its populate and cached steps
   saved, restored into fresh trainers (every tensor of the state bit for
   bit; file MB, save and restore seconds), then original and restored
   take the same 5 steps, held at the card-vs-card margins;
7. evaluate() of the f32 weights through --spmm pallas (B7) and --spmm
   blocked (B9): the host tiling timed apart, the accuracies held to the
   xla route's;
8. holds the SpMM kernels (B7 and B8 at D=100 and 256 in f32 and with
   bf16 compute at 256, B9 at 256) against their plain versions on the
   products graph, and times them beside torch.sparse.mm (B7, B8),
   index_select + mul (B9) and the xla route; holds one B8 call's peak
   memory to its output's;
9. prints the per-kernel JSON line, then the device line.

Since the single-card tools and the other models: after the flagship's
bf16 evaluate() (whose bf16 mean of layer 2 runs the port's
segment_mean_bf16 and that of layer 3's product csr_mean_bf16, counted),
its --eval-sampled accuracies beside the full ones and its --store-emb
table (into a temporary directory, rows held to materialize_features');
after the untimed checks of step 4, segment_mean_bf16 bit for bit against
its plain version on a slice of the products graph around its highest
in-degree row plus rows without in-edges, then timed over the whole graph
beside the chunked index_add_ it replaced, and csr_mean_bf16 the same way
at D = 8 and 48 (bit for bit over the whole graph at 48); tt_fwd, tt_fwd_sr and tt_grads at every rank pair of the
tuner's box (RANK_GRID) against their plain versions, and at 256, 256 on
937,984 zipf ids, timed against their bounds; the profiler harness'
TTEmbeddingBenchmark; before those, RGAT on a tiny typed graph against
the CPU and, in a process of its own started with the untimed checks of
step 4 and read before the timed phases, `python -m
falcon_ttdforgnns_torch.cli --autotune --tune-budget 2 --eval-sampled
--store-emb --plot --profile` at a tenth of arxiv (its traces must name
tt_fwd's and tt_grads' kernels).  After final-p's phases: the README's autotuning
preset at products through cli.run (--tune-budget TUNE_BUDGET, cut from
20), RGAT at MAG240M's R-GAT widths on hard-ogbn-arxiv, and MolGNN at
OGB's mol defaults on synthetic molecule batches, with each of gin/gcn x
five poolings against the CPU at a tiny size.

Since the multi-device slice (ROADMAP C4, A8.1, A8.2, A8.4), after
--sampler table: --dist on the card through a one-rank NCCL group given
to the trainer, so that it takes the data-parallel step (tt_grads, one
all-reduce of every gradient with the loss and accuracy, tt_adam_apply):
5 flagship steps against the single-device trainer's from the same seeds
(counted; how far apart, beside a second single-device run), then, from
the single-device state restored into it, 5 more held at the
card-vs-card bf16 margins; ms a step both ways, a profiled DP epoch (busy,
the all-reduce's records and bytes) and the all-reduce alone.  Then C4,
the mixed flagship's cut epoch of 3 loader batches at --steps-per-call
8: 8 steps (final-p sets --steps-per-call 8 explicitly: its 40 warmup
batches are 5 groups).  After the timed phases: `python -m
torch.distributed.run --standalone --nproc-per-node 1 -m
falcon_ttdforgnns_torch.cli --dist --multihost --mode puregpu --sparse
--bf16 --profile` for an epoch of hard-ogbn-arxiv in a process of its own
(rc 0, its log naming the nccl group of world size 1, its trace both TT
kernels), and beside it graft_entry's entry() and dryrun_multichip(1).

Since --node-shard (ROADMAP A8.3), after --full-neighbor at products: a
one-rank NCCL group given to a --full-neighbor --node-shard trainer of
the flagship's widths (f32, routed Adam, dropout 0), so that it takes the
node-sharded step (a 1 x 1 mesh: its ragged layout's host seconds, chunk
and memory ratio; tt_fwd and tt_grads once a step over all 2,449,029 rows
of the one block, in balanced row order): the first batch's loss and
gradients without an update against the full-graph forward's (loss
within 1e-5, every gradient within 1e-3 of its norm); 3 steps
counted against 3 --full-neighbor steps from the same state, dropout 0,
and a second full-neighbor run beside them (losses within 1e-4;
parameters at hold_params' card-vs-card margin, since Adam's first steps
carry a near-cancelled element's reordering error whole; ms a step and
peak memory); infer_full_sharded against infer_full (logits
within 1e-4, accuracies within SPMM_ROUTE_ACC, evaluate()'s ms both ways);
the ring's index_add_ and index_select ms at D = 256 (CUDA events); then the
ragged layout at LOGICAL_SHARDS = 4 shards consumed in one process, each
shard given at each rotation the block that rotation delivers, through
the ring's own consume and its transpose: equal, bit for bit on
integer-valued rows, to the plain full-graph sum and its transpose.

Since the sampled GAT (gnnbench's gat-tt-products): after --node-shard,
the sampled GAT at its published widths through SageTrainer (--mode
puregpu --bf16 --sparse, 3 layers of 4 heads x 128, fan-out 10,10,10,
batch 512) from gnnbench/reference/gat.py's weights: the first step's
loss and gradients against that reference in float32 on the card, a timed
epoch (seeds/s, peak memory) and evaluate(), counted (three csr_gat_bf16
launches); after segment_mean_bf16's check, csr_gat_bf16 and csr_gat_f32
against their plain version on the CPU on the same slice of rows, then
timed over the whole graph at both layer shapes beside their plain
version and, on a hidden layer, GATConv's f32 scatters and headed_spmm.

The steps run in the order 1, 2, 5, step 6's flagship phases (the main
path, --sampler table, --dist and C4), 6 (e) and (f) with --node-shard,
then 4, 6 (g) and the
flagship's checkpoint beside the orderings, 6 (a)-(c) with final-p's
checkpoint, the tools and models above, 3 in a process of its own (after
the main path's profile, see main()), the rest of 6, 7, 8, the torchrun
CLI run beside the dry run, and 9: no host-timed phase but the
checkpoint's save and restore runs beside the orderings.

Exits non-zero, before printing any result, without a CUDA device or
outside a checkout of the repository; any failed check raises.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

H100_F32_FLOPS = 67e12      # f32 outside the tensor cores (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
ZIPF_A = 1.3
STEPS_MAIN = 5    # the main path, --bf16 --sparse
STEPS_OTHER = 2   # each other path
LR = 3e-3
# Kernel-vs-plain tolerances on max|kernel - plain| / max|plain|, each
# tensor judged on its own scale (each core's gradient; each core's m, v
# or accumulator and change of the core value):
#   tt_fwd: 16-term f32 dots, FMA vs the plain version's bmm order;
#   tt_grads: the grouped walk and its atomics reorder sums of up to ~2.3e5
#     terms (the hottest zipf id is 25% of the batch), sqrt(n) * 2^-24 ~
#     3e-5; the same with a bf16 d_out, which both sides upcast exactly;
#   tt_adam_apply m, v: the same elementwise formula, FMA contraction only;
#   tt_adam_apply core change (new core - old core): when the two updates
#     differ by an ulp, the new cores may round apart by one ulp of the core
#     (3e-8 at |core| 0.38), ~1.6e-5 of the largest change (~1.9e-3);
#   tt_sgd_apply: the plain version's two roundings per value: bit for bit (0);
#   tt_adagrad_apply: the plain arithmetic, operation for operation (no FMA
#     contraction, IEEE sqrt and division): 1e-6;
#   tt_adagrad_apply[rowwise]: the row's sum of g^2 in another order: 1e-5.
# The bf16 stores (tt_fwd[bf16], tt_fwd_sr) are held bit for bit instead
# (BF16_MIN_EQUAL, check_bf16).
TOL = {"tt_fwd": 1e-5, "tt_grads": 1e-4, "tt_adam_apply": 1e-5,
       "tt_adam_apply core change": 1e-4, "tt_sgd_apply": 0.0,
       "tt_adagrad_apply": 1e-6, "tt_adagrad_apply[rowwise]": 1e-5,
       # the SpMMs: each row's sum (~50 terms at products, in-degree up to a
       # few hundred) in another order (FMA, per-warp runs, global vector
       # atomics) than the plain version's index_add_; with bf16 compute both
       # sides round h and w alike, so only the order differs
       "spmm_tiled": 1e-5, "spmm_tiled[bf16]": 1e-5, "spmm_tile_partials": 1e-5,
       "spmm_tile_partials[bf16]": 1e-5}
BF16_MIN_EQUAL = 0.999
STEPS_FULL = 3       # full-graph GCN/GAT steps at full width
FULL_GRAPH_OUTLIERS = 1e-3  # share of parameters past 3e-3 lr, card vs CPU (small_full_graph_check)
FLAT_ADAM_TOL = 0.05  # x lr, card vs CPU after 3 steps, where Adam's step was not normalised (adam_flat)
SPMM_ROUTE_ACC = 1e-3  # --spmm pallas|blocked accuracies against xla's (argmax near-ties)
CACHE_K = 100_000          # final-p's --cache-size
FINAL_P_WARMUP = 40        # final-p's warmup steps (epoch 0), counted by the host loader
FINAL_P_CACHED = 10        # its cached steps (epoch 1), on seeds the warmup did not draw
PUREGPU_CACHE_STEPS = 5    # the puregpu flagship with the cache: steps an epoch
IDS_PER_STEP = 1024 * (1 + 15 + 15 * 10 + 15 * 10 * 5)  # 937,984 at fan-out 5,10,15
STEPS_FULL_NEIGHBOR = 3    # --full-neighbor steps at products
CKPT_STEPS = 5             # steps before a save and after a restore
FINAL_P_GROUP = 8          # final-p's --steps-per-call (the preset's): 40 warmup batches, 5 groups
C4_BATCHES = 3             # loader batches of C4's cut mixed epoch: one ragged group of 8 steps
STEPS_NODE_SHARD = 3       # --full-neighbor --node-shard steps at products, and as many without
LOGICAL_SHARDS = 4         # the ragged layout's shards consumed in one process
TT_SOURCE = "falcon_ttdforgnns_torch/csrc/tt_kernels.cu"
SPMM_SOURCE = "falcon_ttdforgnns_torch/csrc/spmm_kernels.cu"
TOWER_SOURCE = "falcon_ttdforgnns_torch/csrc/tower_kernels.cu"
ATTN_SOURCE = "falcon_ttdforgnns_torch/csrc/attn_kernels.cu"
OPTIM_SOURCE = "falcon_ttdforgnns_torch/csrc/optim_kernels.cu"
# csr_mean_f32 against the card's chunked index_add_ over the whole graph:
# max |diff| over max |plain|, f32 reassociation alone (~4e-7 at products)
CSR_MEAN_REL_TOL = 1e-6
TT_PALLAS = "falcon_ttdforgnns_tpu/ops/tt_pallas.py"
REPLACES = {  # the TPU kernel each one ports (its def line)
    "tt_fwd": f"{TT_PALLAS}:255", "tt_fwd[bf16]": f"{TT_PALLAS}:255",
    "tt_fwd_sr": f"{TT_PALLAS}:261", "tt_grads": f"{TT_PALLAS}:280",
    "tt_grads[bf16]": f"{TT_PALLAS}:280", "tt_sgd_apply": f"{TT_PALLAS}:302",
    "tt_adagrad_apply": f"{TT_PALLAS}:329", "tt_adagrad_apply[rowwise]": f"{TT_PALLAS}:329",
    "tt_adam_apply": f"{TT_PALLAS}:378",
    "spmm_tiled": "falcon_ttdforgnns_tpu/ops/spmm_pallas.py:122",
    "spmm_tiled[bf16]": "falcon_ttdforgnns_tpu/ops/spmm_pallas.py:122",
    "spmm_tile_partials": "falcon_ttdforgnns_tpu/ops/spmm_pallas.py:171",
    "spmm_tile_partials[bf16]": "falcon_ttdforgnns_tpu/ops/spmm_pallas.py:171",
    "spmm_gather": "falcon_ttdforgnns_tpu/ops/spmm_blocked.py:140",
    # no TPU kernel: the XLA bf16 mean of the reference's conv tower, which
    # these kernels reproduce bit for bit
    "fanout_mean_bf16": "falcon_ttdforgnns_tpu/models/sage.py:185",
    "fanout_mean_bf16[bwd]": "falcon_ttdforgnns_tpu/models/sage.py:185",
    # no TPU kernel either: the XLA segment sum of the reference's bf16
    # full-graph mean (spmm_mean), which this kernel reproduces bit for bit
    "segment_mean_bf16": "falcon_ttdforgnns_tpu/ops/segment.py:69",
    # no TPU kernel either: the XLA gather and scatter-add of the reference's
    # f32 full-graph mean (the same spmm_mean), which this kernel sums in
    # edge order
    "csr_mean_f32": "falcon_ttdforgnns_tpu/ops/segment.py:69",
    # none: the JAX package takes every conv's mean before its product; this
    # kernel is the mean of a narrowing conv's product, summed in f32
    "csr_mean_bf16": None,
    # none: the JAX package has no sampled GAT; its full-graph GAT's edge
    # softmax and weighted sum are XLA scatters
    "csr_gat_bf16": None, "csr_gat_f32": None,
    # none: the JAX package leaves the dense Adam to optax, which XLA fuses
    "adam_f32": None}
ARXIV = dict(p_shapes=(50, 60, 60), q_shapes=(8, 4, 4), tt_ranks=(16, 16))  # the arxiv preset


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms, CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ops(fn, reps: int = 1) -> tuple:
    """({name: (calls, device us)} of every kernel and memset that `reps`
    calls of fn() ran on the card (torch.profiler), the wall time of those
    calls in us, and {host op: (calls, device us of the kernels it
    launched)} (the kernels of a library call such as aten::sort, whose
    names are not the port's).  A record_function span shows on the card's
    timeline too, from its first kernel to its last, gaps included: it is
    no kernel, and is left out of the first dict (its name is a host op's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    on_card = [str(getattr(e, "device_type", "")).endswith("CUDA") for e in events]
    host = {e.key: (e.count, getattr(e, "device_time_total", 0))
            for e, card in zip(events, on_card) if not card}
    return ({e.key: (e.count, getattr(e, "self_device_time_total", 0))
             for e, card in zip(events, on_card) if card and e.key not in host}, wall_us, host)


def complete_profile(fn, complete, what: str, reps: int = 1) -> tuple:
    """device_ops(fn, reps), taken again while `complete(ops)` finds device
    records missing, up to three times; (None, None) after the third, so
    that no short profile is reported: a check that needs the profile
    raises, a measurement reads "not measured".  torch.profiler has
    returned sessions with records missing (PERF.md §7).  A missing record
    can only hide work, so `complete` may also raise at once on work that
    should not be there."""
    for attempt in range(3):
        ops, wall_us, under = device_ops(fn, reps)
        if complete(ops):
            return ops, wall_us, under
        log(f"  (torch.profiler missed device records of {what}; attempt {attempt + 1} of 3)")
    log(f"  torch.profiler missed device records of {what} three times: not measured")
    return None, None, None


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn() in ms: the kernels' and memsets' time
    from torch.profiler over `reps` calls after one warm-up, without the
    host's time between launches that the loop of cuda_ms includes.  Each
    call launches at least one kernel; a profile with fewer is taken again,
    and None returned after three (complete_profile)."""
    fn()
    ops, _, _ = complete_profile(fn, lambda ops: sum(c for c, _ in ops.values()) >= reps,
                                 f"{reps} timed calls", reps)
    return None if ops is None else sum(t for _, t in ops.values()) / reps / 1e3


def stream_lookup_us(reps: int = 20000) -> tuple:
    """Host time per call, in us, of the two ways to read the current
    stream: torch.cuda.current_stream().cuda_stream, and the raw handle
    that the kernel wrappers take (ops/_build.current_stream)."""
    import torch
    from falcon_ttdforgnns_torch.ops import _build
    i = torch.cuda.current_device()
    times = []
    for fn in (lambda: torch.cuda.current_stream(i).cuda_stream,
               lambda: _build.current_stream(i)):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    return tuple(times)


def check(name: str, pairs) -> float:
    """Hold each (label, kernel, plain, tolerance key) on its own scale;
    raise if any disagrees.  Returns the largest absolute error."""
    worst_abs, failed = 0.0, []
    for label, got, want, key in pairs:
        abs_err = float((got - want).abs().max())
        rel = abs_err / max(float(want.abs().max()), 1e-30)
        worst_abs = max(worst_abs, abs_err)
        if not rel <= TOL[key]:
            failed.append(label)
        log(f"  {name} {label}: max_abs_err {abs_err:.3e} rel {rel:.3e} "
            f"(tol {TOL[key]:.0e}) {'FAILED' if not rel <= TOL[key] else 'ok'}")
    if failed:
        raise AssertionError(f"{name} disagrees with its plain version: {failed}")
    return worst_abs


def check_bf16(name: str, got, want) -> float:
    """Hold a bf16 store against its plain version bit for bit: at least
    BF16_MIN_EQUAL of the values identical, the rest one bf16 step apart
    (the f32 value before the store may be an ulp off the plain version's,
    which moves the bf16 only on a rounding boundary) or, for a
    near-cancelled sum, within 1e-6 of the largest value.  Returns the
    largest absolute error."""
    import torch
    a = got.view(torch.int16).to(torch.int32)
    b = want.view(torch.int16).to(torch.int32)
    steps = (a - b).abs()
    diff = (got.float() - want.float()).abs()
    far = int(((steps > 1) & (diff > 1e-6 * float(want.float().abs().max()))).sum())
    equal = float((steps == 0).float().mean())
    ok = far == 0 and equal >= BF16_MIN_EQUAL
    log(f"  {name} out: {equal:.6f} of bf16 values bit-identical (min {BF16_MIN_EQUAL}), "
        f"max {int(steps.max())} steps apart, {far} beyond one step and 1e-6 of "
        f"the largest {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return float(diff.max())


def chain_macs(shapes) -> tuple:
    """(forward, backward) multiply-adds per id: the chain recompute, each
    core's gradient and the chain gradient (tt_kernels.cu header)."""
    fr, L = shapes.full_ranks, [1]
    for q in shapes.q_shapes:
        L.append(L[-1] * q)
    T = shapes.ndim
    level = [L[k] * fr[k] * shapes.q_shapes[k] * fr[k + 1] for k in range(T)]
    fwd = sum(level[1:])
    bwd = sum(level[1:T - 1]) + 2 * sum(level[1:])
    return fwd, bwd


def level_macs(shapes) -> tuple:
    """(the last level, P_{T-2}) in multiply-adds: L_{T-1} r_{T-1} q_{T-1}
    and sum_{k=1}^{T-2} L_k r_k q_k r_{k+1} (1,600 and 6,400 at products)."""
    fr, q, T = shapes.full_ranks, shapes.q_shapes, shapes.ndim
    L = [int(np.prod(q[:k])) for k in range(T + 1)]
    return (L[T - 1] * fr[T - 1] * q[T - 1],
            sum(L[k] * fr[k] * q[k] * fr[k + 1] for k in range(1, T - 1)))


def grouped_macs(shapes, per_id: int, per_prefix: int) -> int:
    """The multiply-adds of the grouped backward (the note in
    csrc/tt_kernels.cu): per id twice the last level (the last core's
    gradient row and the chain gradient), per prefix three times P_{T-2}'s
    (P_{T-2} recomputed, then the backward through cores T-2..1).  With
    (distinct ids, prefix runs) the work the function needs; with (pieces,
    segments) the work tt_grads' walk does, the chunk starts' splits
    included.  Exact at 3 cores; at 4 an upper bound (a prefix that keeps
    d_1 keeps P_1)."""
    last, prefix = level_macs(shapes)
    return per_id * 2 * last + per_prefix * 3 * prefix


def fwd_macs(shapes, per_id: int, per_prefix: int) -> int:
    """The multiply-adds of the grouped lookup (the note in
    csrc/tt_kernels.cu): the last level per id, P_{T-2} per prefix; with
    (distinct ids, prefix runs) what the function needs, with (pieces,
    segments) what tt_fwd's walk does.  At 4 cores an upper bound, as
    grouped_macs."""
    last, prefix = level_macs(shapes)
    return per_id * last + per_prefix * prefix


def fwd_bound(shapes, counts: dict, out_size: int) -> tuple:
    """tt_fwd's bound for these ids: the ids (4 B each) read and the output
    (out_size bytes a value) written once, the cores read once; the
    multiply-adds that the distinct ids and prefix runs need (fwd_macs)."""
    B, D = counts["ids"], shapes.embedding_dim
    return bound_ms(4 * B + out_size * B * D + 4 * shapes.num_tt_params,
                    2 * fwd_macs(shapes, counts["distinct"], counts["prefix_runs"]))


def grads_bound(shapes, counts: dict, d_size: int) -> tuple:
    """tt_grads' bound for these ids: the ids (4 B each) and d_out read
    once, the cores read and the gradient written once; the multiply-adds
    that the distinct ids and prefix runs need (grouped_macs)."""
    B, D = counts["ids"], shapes.embedding_dim
    return bound_ms(4 * B + d_size * B * D + 8 * shapes.num_tt_params,
                    2 * grouped_macs(shapes, counts["distinct"], counts["prefix_runs"]))


def walk_line(label: str, shapes, counts: dict, fwd_counts: dict) -> str:
    """The work of tt_grads' walk (counts, at GRADS_CHUNK) and of tt_fwd's
    (fwd_counts, at FWD_CHUNK), each beside what the function needs."""
    parts = []
    for name, macs, c in (("tt_fwd", fwd_macs, fwd_counts), ("tt_grads", grouped_macs, counts)):
        need = macs(shapes, c["distinct"], c["prefix_runs"])
        walk = macs(shapes, c["pieces"], c["segments"])
        parts.append(f"{name} needs {need / 1e9:.4f} GMAC, its walk {c['pieces']} pieces, "
                     f"{c['segments']} segments, {walk / 1e9:.4f} GMAC")
    return (f"{label}: {counts['ids']} ids, {counts['distinct']} distinct, "
            f"{counts['prefix_runs']} prefix runs; " + "; ".join(parts))


def walk_counts(K, shapes, ids) -> tuple:
    """grouped_counts at GRADS_CHUNK and at FWD_CHUNK."""
    counts = K.grouped_counts(shapes, ids)
    return counts, (counts if K.FWD_CHUNK == K.GRADS_CHUNK
                    else K.grouped_counts(shapes, ids, K.FWD_CHUNK))


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_checks(K, shapes, cores, ids, seed, label: str = "", **kw) -> dict:
    """The lookup's three stores (tt_fwd f32 to TOL, tt_fwd[bf16] and
    tt_fwd_sr bit for bit, check_bf16) against their plain versions on these
    ids; kw (chunk, order) go to the kernels.  {name: max_abs_err}."""
    import torch
    err = {"tt_fwd": check(f"tt_fwd{label}", [("out", K.tt_fwd(shapes, cores, ids, **kw),
                                               K.tt_fwd_plain(shapes, cores, ids), "tt_fwd")])}
    err["tt_fwd[bf16]"] = check_bf16(
        f"tt_fwd[bf16]{label}", K.tt_fwd(shapes, cores, ids, torch.bfloat16, **kw),
        K.tt_fwd_plain(shapes, cores, ids, torch.bfloat16))
    err["tt_fwd_sr"] = check_bf16(
        f"tt_fwd_sr{label}", K.tt_fwd_sr(shapes, cores, ids, seed, **kw),
        K.tt_fwd_sr_plain(shapes, cores, ids, seed))
    return err


def kernel_checks(K, shapes, cores, ids, d_out, full: bool):
    """Each kernel against its plain version on the same inputs; with
    `full`, also the times.  Returns per-kernel results."""
    import torch
    dev = ids.device
    seed = torch.tensor(20261016, dtype=torch.int32, device=dev)
    res = {name: {"max_abs_err": e} for name, e in fwd_checks(K, shapes, cores, ids, seed).items()}
    grads = K.tt_grads(shapes, cores, ids, d_out)
    want = K.tt_grads_plain(shapes, cores, ids, d_out)
    res["tt_grads"] = {"max_abs_err": check(
        "tt_grads", [(f"core {k}", g, w, "tt_grads")
                     for k, (g, w) in enumerate(zip(grads, want))])}
    d_bf16 = d_out.to(torch.bfloat16)
    res["tt_grads[bf16]"] = {"max_abs_err": check(
        "tt_grads[bf16]", [(f"core {k}", g, w, "tt_grads") for k, (g, w) in enumerate(
            zip(K.tt_grads(shapes, cores, ids, d_bf16),
                K.tt_grads_plain(shapes, cores, ids, d_bf16)))])}
    b1, b2, eps = 0.9, 0.999, 1e-8
    scal = torch.tensor([LR, 1 / (1 - b1 ** 3), 1 / (1 - b2 ** 3)], device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def state():
        return ([c.clone() for c in cores],
                [torch.rand(c.shape, generator=gen, device=dev) * 1e-3 for c in cores],
                [torch.rand(c.shape, generator=gen, device=dev) * 1e-6 for c in cores])

    got = state()
    want = tuple([t.clone() for t in ts] for ts in got)
    K.tt_adam_apply(*got, grads, scal, b1, b2, eps)
    K.tt_adam_plain(*want, grads, scal, b1, b2, eps)
    pairs = []
    for k, old in enumerate(cores):
        pairs += [(f"core {k} change", got[0][k] - old, want[0][k] - old,
                   "tt_adam_apply core change"),
                  (f"m {k}", got[1][k], want[1][k], "tt_adam_apply"),
                  (f"v {k}", got[2][k], want[2][k], "tt_adam_apply")]
    res["tt_adam_apply"] = {"max_abs_err": check("tt_adam_apply", pairs)}

    got, want = [c.clone() for c in cores], [c.clone() for c in cores]
    K.tt_sgd_apply(got, grads, LR)
    K.tt_sgd_plain(want, grads, LR)
    res["tt_sgd_apply"] = {"max_abs_err": check("tt_sgd_apply", [
        (f"core {k} change", got[k] - old, want[k] - old, "tt_sgd_apply")
        for k, old in enumerate(cores)])}

    def acc_state(rowwise):
        return ([c.clone() for c in cores],
                [torch.rand(c.shape[:1] if rowwise else c.shape, generator=gen,
                            device=dev) * 1e-2 for c in cores])

    for rowwise, name in ((False, "tt_adagrad_apply"), (True, "tt_adagrad_apply[rowwise]")):
        got = acc_state(rowwise)
        want = tuple([t.clone() for t in ts] for ts in got)
        ag_eps = 1e-8 if rowwise else 1e-10
        K.tt_adagrad_apply(*got, grads, LR, ag_eps, rowwise)
        K.tt_adagrad_plain(*want, grads, LR, ag_eps, rowwise)
        pairs = []
        for k, old in enumerate(cores):
            pairs += [(f"core {k} change", got[0][k] - old, want[0][k] - old, name),
                      (f"acc {k}", got[1][k], want[1][k], name)]
        res[name] = {"max_abs_err": check(name, pairs)}
    if not full:
        return res

    B, D, n_tt = ids.shape[0], shapes.embedding_dim, shapes.num_tt_params
    rows = sum(shapes.p_shapes)
    macs_f, macs_b = chain_macs(shapes)

    def timed(name, kernel, plain, library, bound, reps=10, plain_reps=3, on_device=False):
        """Loop ms of kernel, plain version and library call (CUDA events
        around `reps` calls back to back); with `on_device`, also the
        device ms per call of kernel and library call (torch.profiler).
        `bound`: bound_ms's (ms, by) for this work."""
        r = res[name]
        r.update(ms=cuda_ms(kernel, reps), plain_ms=cuda_ms(plain, plain_reps),
                 library_ms=None if library is None else cuda_ms(library, reps))
        if on_device:
            r.update(device_ms=device_ms(kernel),
                     library_device_ms=None if library is None else device_ms(library))
        r["bound_ms"], r["bound_by"] = bound

    # tt_fwd and tt_grads: the bound from the multiply-adds that these ids'
    # distinct ids and prefix runs need (tt_grads' atomics run in L2, not on
    # the FMA pipes); the call's time includes the sort of the ids, timed
    # apart too, and tt_fwd's kernel is also timed with the order given.
    # The log gives the bound of the reference's per-id chain as well
    # (8,000 and 22,400 multiply-adds an id at the products shapes), work
    # the kernels no longer do
    counts, fwd_counts = walk_counts(K, shapes, ids)
    log("  " + walk_line("the draw", shapes, counts, fwd_counts))
    sort_ms = cuda_ms(lambda: K.grouped_order(ids), 10)
    order = K.grouped_order(ids)
    chain_bound = {}
    # the ~12 integer operations of the SR hash per element are not counted
    for name, call, plain, size in (
            ("tt_fwd", lambda **kw: K.tt_fwd(shapes, cores, ids, **kw),
             lambda: K.tt_fwd_plain(shapes, cores, ids), 4),
            ("tt_fwd[bf16]", lambda **kw: K.tt_fwd(shapes, cores, ids, torch.bfloat16, **kw),
             lambda: K.tt_fwd_plain(shapes, cores, ids, torch.bfloat16), 2),
            ("tt_fwd_sr", lambda **kw: K.tt_fwd_sr(shapes, cores, ids, seed, **kw),
             lambda: K.tt_fwd_sr_plain(shapes, cores, ids, seed), 2)):
        timed(name, call, plain, None, fwd_bound(shapes, fwd_counts, size))
        res[name].update(sort_ms=sort_ms,
                         kernel_ms=cuda_ms(lambda call=call: call(order=order), 10))
        chain_bound[name] = bound_ms(4 * (B + n_tt) + size * B * D, 2 * macs_f * B)[0]
    for name, d, size in (("tt_grads", d_out, 4), ("tt_grads[bf16]", d_bf16, 2)):
        timed(name, lambda d=d: K.tt_grads(shapes, cores, ids, d),
              lambda d=d: K.tt_grads_plain(shapes, cores, ids, d), None,
              grads_bound(shapes, counts, size))
        res[name]["sort_ms"] = sort_ms
        chain_bound[name] = bound_ms(4 * B + size * B * D + 8 * n_tt, 2 * macs_b * B)[0]
    del order

    def params_with(gs):
        ps = [torch.nn.Parameter(c.clone()) for c in cores]
        for p, g in zip(ps, gs):
            p.grad = g.clone()
        return ps

    st, st_plain = state(), state()
    fused = torch.optim.Adam(params_with(grads), lr=LR, betas=(b1, b2), eps=eps, fused=True)
    timed("tt_adam_apply", lambda: K.tt_adam_apply(*st, grads, scal, b1, b2, eps),
          lambda: K.tt_adam_plain(*st_plain, grads, scal, b1, b2, eps), fused.step,
          bound_ms(4 * 7 * n_tt + 12, 12 * n_tt), reps=50, plain_reps=20, on_device=True)
    c_k, c_p, c_l = ([c.clone() for c in cores] for _ in range(3))
    timed("tt_sgd_apply", lambda: K.tt_sgd_apply(c_k, grads, LR),
          lambda: K.tt_sgd_plain(c_p, grads, LR),
          lambda: torch._foreach_add_(c_l, grads, alpha=-LR),
          bound_ms(4 * 3 * n_tt, 2 * n_tt), reps=50, plain_reps=20, on_device=True)
    ag_k, ag_p = acc_state(False), acc_state(False)
    adagrad = torch.optim.Adagrad(params_with(grads), lr=LR, eps=1e-10, foreach=True)
    timed("tt_adagrad_apply", lambda: K.tt_adagrad_apply(*ag_k, grads, LR, 1e-10),
          lambda: K.tt_adagrad_plain(*ag_p, grads, LR, 1e-10), adagrad.step,
          bound_ms(4 * 5 * n_tt, 7 * n_tt), reps=50, plain_reps=20, on_device=True)
    rw_k, rw_p = acc_state(True), acc_state(True)
    timed("tt_adagrad_apply[rowwise]",
          lambda: K.tt_adagrad_apply(*rw_k, grads, LR, 1e-8, True),
          lambda: K.tt_adagrad_plain(*rw_p, grads, LR, 1e-8, True), None,
          bound_ms(4 * 3 * n_tt + 4 * 2 * rows, 6 * n_tt), reps=50, plain_reps=20,
          on_device=True)

    def ms4(x, absent):
        return absent if x is None else f"{x:.4f} ms"

    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev = ""
        if "device_ms" in r:
            lib_dev = ms4(r["library_device_ms"],
                          "none" if r["library_ms"] is None else "not measured")
            dev = f"; on the device {ms4(r['device_ms'], 'not measured')}, library {lib_dev}"
        if "kernel_ms" in r:
            dev += f"; with the order given {r['kernel_ms']:.4f} ms"
        if name in chain_bound:
            dev += (f"; of it the sort {r['sort_ms']:.4f} ms; the per-id chain's bound "
                    f"{chain_bound[name]:.4f} ms")
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{lib} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}){dev}")
    return res


def kernel_phase(dev):
    """Step 3: the kernels at the products shapes and two small cases."""
    import torch
    from falcon_ttdforgnns_torch.ops import tt_kernels as K
    from falcon_ttdforgnns_torch.ops import tt_init
    from falcon_ttdforgnns_torch.ops.tt_shapes import TTShapes, make_tt_shapes
    shapes = make_tt_shapes(2_449_029, 100, (16, 16), (125, 140, 140), (5, 5, 4))
    rng = np.random.default_rng(0)
    cores = [torch.tensor(c, device=dev)
             for c in tt_init.init_tt_cores(shapes, "approx-normal", 0)]
    B = 1024 * (1 + 15 + 150 + 750)
    perm = rng.permutation(shapes.num_embeddings)
    ids = torch.tensor(perm[(rng.zipf(ZIPF_A, B) - 1) % shapes.num_embeddings]
                       .astype(np.int32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_out = torch.randn((B, shapes.embedding_dim), generator=gen, device=dev)
    public_us, raw_us = stream_lookup_us()
    log(f"current stream, host time per call: torch.cuda.current_stream().cuda_stream "
        f"{public_us:.3f} us, the raw handle the wrappers take {raw_us:.3f} us")
    log(f"kernels at the products shapes, {B} zipf({ZIPF_A}) ids:")
    res = kernel_checks(K, shapes, cores, ids, d_out, full=True)
    seed = torch.tensor(7, dtype=torch.int32, device=dev)
    for small in (TTShapes(256, 64, (16, 16), (8, 8), (12,)),
                  TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))):
        log(f"kernels at {small.ndim} cores, p={small.p_shapes}, 1001 ids:")
        c = [torch.tensor(x, device=dev) for x in tt_init.init_tt_cores(small, "normal", 1)]
        i = torch.tensor(rng.integers(0, small.num_embeddings, 1001).astype(np.int32), device=dev)
        g = torch.randn((1001, small.embedding_dim), generator=gen, device=dev)
        kernel_checks(K, small, c, i, g, full=False)
        # a hot id, 400 of the 1001, spans many chunks of 1 and 3 positions
        hot = torch.tensor(rng.permutation(np.concatenate([
            np.full(400, small.num_embeddings // 2),
            rng.integers(0, small.num_embeddings, 601)])).astype(np.int32), device=dev)
        for chunk in (1, 3):
            log(f"  the lookup on a hot id (400 of 1001 ids), chunk {chunk}:")
            fwd_checks(K, small, c, hot, seed, f" chunk {chunk}", chunk=chunk)
    return res


def small_step_check(dev):
    """Step 4: the train step on the card (kernels) against the same step
    on the CPU (plain versions), on a tiny graph with dropout off, for each
    path.  In f32 the two agree to f32 rounding (Adam's and adagrad's
    normalised steps carry a near-cancelled gradient element's reordering
    error into a difference of a fraction of lr).  Under bf16 the two
    devices round their bf16 products apart (and --bf16-sr dithers with
    each device's own seed), so the loss is held to 2e-3 and at most 5% of
    each parameter's elements may be more than 0.1 lr apart (a near-zero
    gradient element of the other sign moves Adam by up to 2 lr).  With
    --bf16-sr the card's trainer takes the CPU trainer's SR seeds, so both
    dither alike."""
    import torch
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5,
                                feat_dim=64, seed=1)
    paths = [dict(sparse=True), dict(sparse=False),
             dict(sparse=True, tt_optimizer="sgd"), dict(sparse=True, tt_optimizer="adagrad"),
             dict(sparse=True, tt_optimizer="rowwise_adagrad"),
             dict(sparse=True, bf16=True), dict(sparse=True, bf16=True, bf16_sr=True)]
    for kw in paths:
        cfg = TrainConfig(batch_size=128, fanouts=(3, 4), hidden_dim=32, num_layers=2,
                          tt_ranks=(8, 8), dropout=0.0, seed=1, lr=LR, **kw)
        bf16 = cfg.bf16
        gpu, cpu = SageTrainer(ds, cfg, device=dev), SageTrainer(ds, cfg, device="cpu")
        if cfg.bf16_sr:  # the card's trainer takes the CPU trainer's seeds
            drawn, cpu_draw = [], cpu._sr_seed

            def cpu_seed():
                drawn.append(cpu_draw())
                return drawn[-1]

            cpu._sr_seed = cpu_seed
            gpu._sr_seed = lambda: drawn[-1].to(dev)
        for step, batch in zip(range(3), gpu.loader):
            lc, _ = cpu.train_step(batch.seeds, batch.layers, batch.labels)
            lg, _ = gpu.train_step(batch.seeds, batch.layers, batch.labels)
            hold_loss(kw, step, lg, lc, bf16)
        hold_params(kw, gpu, cpu, bf16)


def hold_loss(kw, step, on_card, on_cpu, bf16: bool) -> None:
    """small_step_check's loss tolerance: 2e-3 under bf16, else 1e-4."""
    if not math.isclose(float(on_card), float(on_cpu), rel_tol=2e-3 if bf16 else 1e-4):
        raise AssertionError(f"{kw} step {step}: loss on the card {float(on_card)} "
                             f"vs on the CPU {float(on_cpu)}")


def hold_params(kw, gpu, cpu, bf16: bool, flat=None, steps: int = 3,
                where: str = "tiny graph") -> None:
    """small_step_check's parameter tolerances after `steps` steps.  In f32,
    `flat` (from adam_flat) may name, per parameter, the elements whose
    Adam step was not normalised on either side: those are held to
    FLAT_ADAM_TOL instead of 3e-3 lr."""
    import torch
    offs = [(a.detach().cpu() - b.detach().cpu()).abs()
            for a, b in zip(gpu.model.parameters(), cpu.model.parameters())]
    if bf16:
        err = max(float(o.max()) for o in offs)
        share = max(float((o > 0.1 * LR).float().mean()) for o in offs)
        ok = share <= 0.05 and err <= 3 * 2 * LR + 1e-6
        what = f"share > 0.1 lr apart {share:.4f} (tol 0.05), max {err:.3e}"
    else:
        flat = flat or [torch.zeros_like(o, dtype=torch.bool) for o in offs]
        err = max(float(o.masked_fill(f, 0.0).max()) for o, f in zip(offs, flat))
        ok = err <= 3 * 1e-3 * LR
        what = f"max param diff {err:.3e} (tol {3 * 1e-3 * LR:.1e})"
        if any(bool(f.any()) for f in flat):
            ferr = max(float(o.masked_fill(~f, 0.0).max()) for o, f in zip(offs, flat))
            past = sum(int((o.masked_fill(~f, 0.0) > 3 * 1e-3 * LR).sum())
                       for o, f in zip(offs, flat))
            ok = ok and ferr <= FLAT_ADAM_TOL * LR
            what += (f" but for {sum(int(f.sum()) for f in flat)} elements with an unnormalised "
                     f"Adam step: {past} past it, max {ferr:.3e} (tol {FLAT_ADAM_TOL * LR:.1e})")
    log(f"  {where} {kw}: {steps} steps, loss ok, {what} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{kw}: params disagree")


def adam_flat(trainer) -> list:
    """Per parameter of trainer.model, the elements whose last Adam step
    was not normalised: a bias-corrected v at or below ADAM_EPS^2, so |g|
    is at most eps and the step is about lr * g / eps rather than lr *
    sign(g).  There a near-cancelled gradient's f32 reordering error (one
    such element of convs.0.lin_self.weight: 3.11e-9 on the card against
    3.34e-9 on the CPU) moves the parameter by a share of lr (0.013 lr;
    PERF.md §6), on the CPU side alone."""
    from falcon_ttdforgnns_torch.train.optim import ADAM_EPS, bias_corrections
    flat = {}
    for params, state in ((trainer.opt_params, trainer.opt_state),
                          (trainer.cores, trainer.tt_opt)):
        if state is not None:
            bc2 = float(bias_corrections(state.count)[1])
            for p, v in zip(params, state.v):
                flat[id(p)] = (v / bc2 <= ADAM_EPS ** 2).cpu()
    return [flat[id(p)] for p in trainer.model.parameters()]


def tap_sampler(trainer) -> list:
    """Wrap trainer.sample_layers: each call runs under the profiler span
    "device_sample" (its kernels' device time apart from the step's), and
    its seeds and layers are kept, on the card, in the returned list.
    `del trainer.sample_layers` undoes it."""
    import torch
    kept, inner = [], trainer.sample_layers

    def sample(seeds):
        with torch.profiler.record_function("device_sample"):
            layers = inner(seeds)
        kept.append((seeds, layers))
        return layers

    trainer.sample_layers = sample
    return kept


def small_puregpu_check(dev):
    """Step 4, --mode puregpu: 3 steps on the card that sample on the card
    (--sampler csr in f32 --sparse, --sampler table under --bf16 --sparse),
    beside the card's --mode mixed steps and the CPU trainer's on the
    layers the card sampled, each held at small_step_check's tolerances:
    the puregpu step to the card's mixed step, and to the CPU's.  In f32
    against the CPU, an element whose Adam step was not normalised after
    some step, on either side (adam_flat), is held to FLAT_ADAM_TOL
    instead."""
    import torch
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5,
                                feat_dim=64, seed=1)
    order = np.random.default_rng(1).permutation(ds.train_idx)
    for kw in (dict(sparse=True), dict(sparse=True, bf16=True, sampler="table",
                                       table_width=16)):
        cfg = TrainConfig(batch_size=128, fanouts=(3, 4), hidden_dim=32, num_layers=2,
                          tt_ranks=(8, 8), dropout=0.0, seed=1, lr=LR, mode="puregpu", **kw)
        mixed = TrainConfig(**{**cfg.__dict__, "mode": "mixed"})
        gpu, gmix = SageTrainer(ds, cfg, device=dev), SageTrainer(ds, mixed, device=dev)
        cpu = SageTrainer(ds, mixed, device="cpu")
        kept = tap_sampler(gpu)
        label = dict(kw, mode="puregpu")
        flat = None
        for step in range(3):
            pick = order[step * 128:(step + 1) * 128]
            seeds, labels = pick.astype(np.int32), ds.labels[pick].astype(np.int32)
            lg, _ = gpu.device_train_step(torch.as_tensor(seeds, device=dev),
                                          torch.as_tensor(labels, device=dev))
            layers = kept[-1][1]
            lm, _ = gmix.train_step(seeds, layers, labels)
            lc, _ = cpu.train_step(seeds, [l.cpu() for l in layers], labels)
            hold_loss(dict(label, against="the card's mixed step"), step, lg, lm, cfg.bf16)
            hold_loss(label, step, lg, lc, cfg.bf16)
            now = [a | b for a, b in zip(adam_flat(gpu), adam_flat(cpu))]
            flat = now if flat is None else [a | b for a, b in zip(flat, now)]
        hold_params(dict(label, against="the card's mixed step"), gpu, gmix, cfg.bf16)
        hold_params(label, gpu, cpu, cfg.bf16, flat)


def train_steps(trainer, batches, label):
    import torch
    losses = []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc = trainer.train_step(b.seeds, b.layers, b.labels)
        loss = float(loss)  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        log(f"  {label} step {i}: {ms:.1f} ms loss {loss:.4f} acc {float(acc):.4f}")
        if not math.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss}")
        losses.append((ms, loss))
    return losses


def kernel_modules():
    """The wrapper modules, each with its KERNELS and launch counts."""
    from falcon_ttdforgnns_torch.ops import (adam, attention, segment, spmm_blocked, spmm_tiled,
                                             tower, tt_kernels)
    return tt_kernels, spmm_tiled, spmm_blocked, tower, segment, attention, adam


def reset_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def launched() -> dict:
    """The nonzero launch counts of every kernel variant."""
    return {k: v for m in kernel_modules() for k, v in m.launch_counts().items() if v}


UPDATES = ("tt_adam_apply", "tt_sgd_apply", "tt_adagrad_apply", "tt_adagrad_apply[rowwise]")


def counted_steps(trainer, batches, label, must_launch):
    """Steps with the launch counters zeroed just before and read just
    after; raise unless each kernel in `must_launch` launched.  The update
    wrapper validates its cores' and optimizer state's argument set anew
    (an argument-cache miss) at most once, on the first step: raise if it
    did so more often.  Each step does one TT lookup and sorts its ids
    once, for tt_fwd and tt_grads alike: raise on another count of sorts.
    Returns the counts."""
    reset_counts()
    train_steps(trainer, batches, label)
    return checked_counts(label, must_launch, len(batches))


def checked_counts(label: str, must_launch, steps: int) -> dict:
    """The launch counts of `steps` steps just run (counted_steps' checks)."""
    from falcon_ttdforgnns_torch.ops import tt_kernels
    counts = launched()
    updates = sum(counts.get(k, 0) for k in UPDATES)
    misses = tt_kernels.arg_cache_misses()
    sorts = tt_kernels.sort_count()
    log(f"  launches: {counts}; update argument sets validated anew: {misses} of "
        f"{updates} update launches; sorts of the ids: {sorts} in {steps} steps")
    missing = [k for k in must_launch if not counts.get(k)]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: {counts}")
    if sorts != steps:
        raise AssertionError(f"{label}: {sorts} sorts of the ids in {steps} steps")
    if misses > 1:
        raise AssertionError(f"{label}: the update's arguments were validated anew {misses} "
                             f"times in {updates} launches: the argument cache misses")
    return counts


def checked_evaluate(trainer, label, must_launch=("tt_fwd",)):
    """evaluate() twice (the first call moves the edge list to the card and
    builds a route's tiling); raise unless the accuracies are in [0, 1] and
    the kernels of `must_launch` ran in the first call.  Returns the
    accuracies and that call's launch counts."""
    import torch
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accs = trainer.evaluate()
    first = (time.perf_counter() - t0) * 1e3
    counts = launched()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.evaluate()
    log(f"  {label}: {first:.0f} ms (first call, includes moving the edge list to "
        f"the card), second call {(time.perf_counter() - t0) * 1e3:.0f} ms (peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB), {accs}, "
        f"launches {counts}")
    missing = [k for k in must_launch if not counts.get(k)]
    if not all(0.0 <= a <= 1.0 for a in accs.values()) or missing:
        raise AssertionError(f"evaluate() gave {accs}, {missing} never launched")
    return accs, counts


def chunk_sweep(K, shapes, id_batches, dev) -> None:
    """tt_fwd storing bf16 and tt_grads with a bf16 d_out, as on the main
    path, on the main path's own ids at 32, 64 and 128 sorted positions a
    warp (FWD_CHUNK and GRADS_CHUNK are chosen from these), each given the
    step's sort as the trainer gives it (the sort is not timed): loop ms
    per call of each batch, the chunks taking turns within a batch, and
    each chunk's pieces and segments."""
    import torch
    from falcon_ttdforgnns_torch.ops import tt_init
    cores = [torch.tensor(c, device=dev)
             for c in tt_init.init_tt_cores(shapes, "approx-normal", 0)]
    gen = torch.Generator(device=dev).manual_seed(1)
    chunks = (32, 64, 128)
    times = {(k, c): [] for k in ("tt_fwd[bf16]", "tt_grads[bf16]") for c in chunks}
    for ids in id_batches:
        d = torch.randn((ids.shape[0], shapes.embedding_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        order = K.grouped_order(ids)
        for c in chunks:
            times["tt_fwd[bf16]", c].append(cuda_ms(lambda: K.tt_fwd(
                shapes, cores, ids, torch.bfloat16, order=order, chunk=c), 10))
            times["tt_grads[bf16]", c].append(cuda_ms(lambda: K.tt_grads(
                shapes, cores, ids, d, chunk=c, order=order), 10))
    for c in chunks:
        walk = K.grouped_counts(shapes, id_batches[0], c)
        for name, default in (("tt_fwd[bf16]", K.FWD_CHUNK), ("tt_grads[bf16]", K.GRADS_CHUNK)):
            log(f"  {name} at chunk {c}{' (the default)' if c == default else ''}: "
                f"{', '.join(f'{t:.4f}' for t in times[name, c])} ms on the "
                f"{len(id_batches)} steps' ids, the sort not timed (step 0: "
                f"{walk['pieces']} pieces, {walk['segments']} segments)")


def counted_epoch(trainer, epoch: int, label: str, must_launch, steps: int) -> dict:
    """train_epoch(epoch), `steps` steps, with the launch counters zeroed just
    before and read just after, and counted_steps' checks.  Returns the
    counts."""
    reset_counts()
    stats = trainer.train_epoch(epoch)
    log(f"  {label} epoch {epoch}: {steps} steps in {stats['epoch_time'] * 1e3:.1f} ms, "
        f"{stats['samples_per_s']:.0f} seeds/s, loss {stats['loss']:.4f}")
    if trainer.step != (epoch + 1) * steps or not math.isfinite(stats["loss"]):
        raise AssertionError(f"{label}: {trainer.step} steps, stats {stats}")
    return checked_counts(label, must_launch, steps)


def profile_epoch(trainer, epoch: int, steps: int, K, ids) -> dict:
    """Where a --mode puregpu epoch's device time goes: torch.profiler over
    train_epoch(epoch), kernels ranked by device time, the device's busy
    share of the window's wall time, and the sampler's kernels (the
    "device_sample" span of tap_sampler) apart.  A window in which the
    profiler missed a record of the TT kernels (one launch of each per
    step) is taken again, up to three times; after the third the breakdown
    is not measured.  Raises unless the window sorted once a step (its
    aten::sort records against those of one grouped_order call on `ids`,
    profiled after the window, so that the window is the process's first
    profiler session; PERF.md §7) and copied from the host to the card
    once, the epoch's seeds and labels (no layer ids cross).  Returns
    {busy_ms, wall_ms, sample_ms} per step."""
    import torch
    n = steps

    def complete(ops):
        tt = {re.search(r"tt_\w+_kernel<[^>]*>", k).group(0): c for k, (c, _) in ops.items()
              if "tt_fwd_kernel" in k or "tt_grads_kernel" in k}
        if sorted(tt.values()) != [n, n]:
            log(f"  TT kernel records {tt} for {n} steps")
        return sorted(tt.values()) == [n, n]

    ops, wall_us, under = complete_profile(lambda: trainer.train_epoch(epoch), complete,
                                           f"a {n}-step puregpu epoch")
    if ops is None:
        return dict(busy_ms=None, wall_ms=None, sample_ms=None)
    _, _, one = device_ops(lambda: K.grouped_order(ids))
    per_sort = one.get("aten::sort", (0, 0))[0]
    sorts = under.get("aten::sort", (0, 0))[0]
    h2d = {k: c for k, (c, _) in ops.items() if "HtoD" in k}
    log(f"  aten::sort records: {sorts} in {n} steps, {per_sort} for one grouped_order call; "
        f"host-to-device copies: {h2d}")
    if per_sort == 0 or sorts != n * per_sort:
        raise AssertionError(f"{n} puregpu steps made {sorts} aten::sort records, "
                             f"one sort a step makes {per_sort}")
    if sum(h2d.values()) != 1:
        raise AssertionError(f"a one-group puregpu epoch copied to the card {h2d}: only its "
                             f"seeds and labels should cross, once")
    rows = [(us, key, count) for key, (count, us) in ops.items()]
    busy_us = sum(r[0] for r in rows)
    sample_us = under.get("device_sample", (0, 0))[1]
    fwd_us, grads_us = (sum(us for key, (_, us) in ops.items() if name in key)
                        for name in ("tt_fwd_kernel", "tt_grads_kernel"))
    sort_us = under.get("aten::sort", (0, 0))[1]
    log(f"  profiled epoch of {n} steps: {wall_us / n / 1e3:.2f} ms per step (profiler on), "
        f"device busy {busy_us / n / 1e3:.3f} ms per step = {busy_us / wall_us:.1%} of wall; "
        f"the sampler's kernels {sample_us / n / 1e3:.3f} ms per step "
        f"({under.get('device_sample', (0, 0))[0]} spans), the sort {sort_us / n / 1e3:.3f}, "
        f"tt_fwd {fwd_us / n / 1e3:.3f}, tt_grads {grads_us / n / 1e3:.3f}")
    for us, key, count in sorted(rows, reverse=True)[:12]:
        log(f"    {us / n / 1e3:8.3f} ms/step {us / max(busy_us, 1e-9):6.1%}  "
            f"x{count / n:<5.1f} {key[:90]}")
    return dict(busy_ms=busy_us / n / 1e3, wall_ms=wall_us / n / 1e3,
                sample_ms=sample_us / n / 1e3)


def host_sampled_steps(trainer, steps: int, must_launch) -> float:
    """--mode mixed as train_epoch runs it: sample a batch on the host, then
    the step, `steps` times, with the launch counters zeroed before and read
    after.  Returns the ms per step."""
    import torch
    loader_it = iter(trainer.loader)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        b = next(loader_it)
        loss = trainer.train_step(b.seeds, b.layers, b.labels)[0]
    loss = float(loss)
    per_step = (time.perf_counter() - t0) / steps
    counts = launched()
    log(f"  --mode mixed, sample on the host + step, as in train_epoch: {per_step * 1e3:.1f} ms "
        f"per step, {trainer.cfg.batch_size / per_step:.0f} seeds/s, loss {loss:.4f}; "
        f"launches {counts}")
    missing = [k for k in must_launch if counts.get(k) != steps]
    if missing or not math.isfinite(loss):
        raise AssertionError(f"mixed steps: {missing} not launched once a step: {counts}")
    return per_step * 1e3


def edges_of(g, parents: np.ndarray, children: np.ndarray) -> np.ndarray:
    """Whether each child (children (M, f)) is an in-neighbour of its
    parent (parents (M,)), or the parent itself when it is isolated: the
    (parent, neighbour) pairs of the parents' adjacency lists, as sorted
    keys, against the sampled pairs."""
    n = g.num_nodes
    deg = np.diff(g.indptr)[parents]
    uniq = np.unique(parents[deg > 0]).astype(np.int64)
    d = np.diff(g.indptr)[uniq].astype(np.int64)
    starts = np.repeat(g.indptr[uniq].astype(np.int64) - (np.cumsum(d) - d), d)
    keys = np.sort(np.repeat(uniq, d) * n + g.indices[np.arange(d.sum()) + starts])
    want = parents.astype(np.int64)[:, None] * n + children.astype(np.int64)
    ok = np.isin(want, keys)
    isolated = deg == 0
    ok[isolated] = children[isolated] == parents[isolated, None]
    return ok


def binomial_check(label: str, draws: np.ndarray, pool: np.ndarray, bins: int = 64) -> None:
    """Uniform draws over `pool` (an adjacency list or a table row, values
    repeated by their multiplicity): the distinct values, in order, cut
    into at most `bins` groups; each group's count within 4 binomial sigma
    + 1 of its share (the JAX package's bound, tests/test_flags.py; groups
    keep a node of thousands of neighbours from failing by chance among as
    many bins); raises also on a draw outside the pool."""
    uniq, mult = np.unique(pool, return_counts=True)
    pos = np.searchsorted(uniq, draws)
    if (pos >= len(uniq)).any() or (uniq[np.minimum(pos, len(uniq) - 1)] != draws).any():
        raise AssertionError(f"{label}: a draw outside the pool")
    group = np.arange(len(uniq)) * min(bins, len(uniq)) // len(uniq)
    p = np.bincount(group, mult) / len(pool)
    counts = np.bincount(group[pos], minlength=len(p))
    z = np.abs(counts - len(draws) * p) / np.maximum(np.sqrt(len(draws) * p * (1 - p)), 1e-12)
    ok = (np.abs(counts - len(draws) * p) < 4 * np.sqrt(len(draws) * p * (1 - p)) + 1).all()
    log(f"  {label}: {len(draws)} draws over {len(uniq)} distinct values in {len(p)} groups, "
        f"largest |count - mean| {z.max():.2f} sigma (tol 4 sigma + 1) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: draws not uniform")


def sampler_check(ds, trainer, kept, dev) -> None:
    """The in-step sampler of `trainer` on the card at products: every id
    of the kept steps in range; for 256 seeds of the first, every hop's ids
    in-neighbours of their parents (or the isolated parent itself); the
    highest-degree node's 2^20 draws uniform (binomial_check): over its
    adjacency list (--sampler csr) or over its table row's 32 slots
    (--sampler table)."""
    import torch
    from falcon_ttdforgnns_torch.graph import device_sampler as S
    g, n = ds.graph, ds.num_nodes
    name = trainer.cfg.sampler
    lo = min(int(l.min()) for _, layers in kept for l in layers)
    hi = max(int(l.max()) for _, layers in kept for l in layers)
    seeds, layers = kept[0]
    prev = seeds[:256].cpu().numpy().reshape(-1, 1)
    ok, pairs = True, 0
    for f, lay in zip(reversed(trainer.cfg.fanouts), layers):
        lay = lay[:256].cpu().numpy()
        member = edges_of(g, prev.reshape(-1), lay.reshape(-1, f))
        ok &= bool(member.all())
        pairs += member.size
        prev = lay
    log(f"  --sampler {name}: ids of {len(kept)} steps in [{lo}, {hi}] of {n} nodes; "
        f"256 seeds' {pairs} sampled ids each an in-neighbour of its parent "
        f"{'ok' if ok else 'FAILED'}")
    if lo < 0 or hi >= n or not ok:
        raise AssertionError(f"--sampler {name}: sampled ids out of range or not neighbours")
    v = int(np.argmax(np.diff(g.indptr)))
    gen = torch.Generator(device=dev).manual_seed(7)
    node = torch.tensor([v], dtype=torch.int32, device=dev)
    if name == "table":
        draws = S.device_sample_block_table(trainer._table_dev, node, (1 << 20,), gen)[0]
        pool = trainer._table_dev[v].cpu().numpy()
    else:
        draws = S.device_sample_neighbors(trainer._indptr_dev, trainer._indices_dev, node,
                                          1 << 20, gen)
        pool = g.indices[g.indptr[v]:g.indptr[v + 1]]
    binomial_check(f"--sampler {name}, node {v} (in-degree {np.diff(g.indptr)[v]})",
                   draws.cpu().numpy().reshape(-1), pool)


def small_full_graph_check(dev):
    """Step 4, full graph: 3 GCN (--spmm xla and blocked) and GAT steps on
    the card against the same steps on the CPU (plain versions) on a tiny
    graph, both dropouts 0: GAT's attention dropout, fixed at 0.05 in the
    model, is set to 0 on both sides, since the two devices' dropout bits
    differ.  The card tiles the blocked SpMM at 4096/512 slots and the CPU
    at 256/8, so sums run in other orders: losses within 1e-4; parameters
    within 3e-3 lr, but for at most FULL_GRAPH_OUTLIERS of the elements,
    which may be up to Adam's largest steps apart (2 lr a step): AdamW's
    normalised step carries a near-cancelled gradient element's reordering
    error into a difference of a fraction of lr, and GAT's largest
    difference read 3.0e-7 to 1.52e-5 (3.0e-3 lr) in five runs of the same
    code (PERF.md §7)."""
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import FullGraphConfig, FullGraphTrainer
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5,
                                feat_dim=64, seed=1)
    for kw in (dict(model="gcn"), dict(model="gcn", spmm="blocked"), dict(model="gat")):
        cfg = FullGraphConfig(hidden_dim=32, num_layers=2, num_heads=2, tt_ranks=(8, 8),
                              dropout=0.0, warmup_epochs=3, use_linear=True, seed=1, **kw)
        gpu, cpu = FullGraphTrainer(ds, cfg, device=dev), FullGraphTrainer(ds, cfg, device="cpu")
        for tr in (gpu, cpu):
            for conv in tr.model.gnn.convs:
                if hasattr(conv, "attn_dropout"):
                    conv.attn_dropout = 0.0
        for e in range(3):
            lg, lc = gpu.train_epoch(e)["loss"], cpu.train_epoch(e)["loss"]
            if not math.isclose(lg, lc, rel_tol=1e-4):
                raise AssertionError(f"{kw} step {e}: loss on the card {lg} vs on the CPU {lc}")
        offs = [(a.detach().cpu() - b.detach()).abs()
                for a, b in zip(gpu.model.parameters(), cpu.model.parameters())]
        err, tol = max(float(o.max()) for o in offs), 3 * 1e-3 * cfg.lr
        share = sum(int((o > tol).sum()) for o in offs) / sum(o.numel() for o in offs)
        ok = share <= FULL_GRAPH_OUTLIERS and err <= 3 * 2 * cfg.lr
        log(f"  tiny graph full-graph {kw}: 3 steps, loss card vs CPU ok, max param diff "
            f"{err:.3e} (tol {3 * 2 * cfg.lr:.1e}), share beyond {tol:.1e} {share:.2e} "
            f"(tol {FULL_GRAPH_OUTLIERS:.0e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{kw}: params on the card and on the CPU disagree")


def full_graph_phase(dev):
    """Step 5: full-graph GCN (--spmm xla and blocked) and GAT at full width
    on the full-size hard-ogbn-arxiv graph, the reference's arxiv recipe.
    Returns each run's launch counts."""
    import torch
    from falcon_ttdforgnns_torch.graph import get_dataset, reorder_permutation
    from falcon_ttdforgnns_torch.train import FullGraphConfig, FullGraphTrainer
    t0 = time.perf_counter()
    ds = get_dataset("hard-ogbn-arxiv", seed=0)
    ds = ds.permute(reorder_permutation(ds.graph, 0, seed=0))
    log(f"dataset {ds.name}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
        f"{ds.num_classes} classes, {time.perf_counter() - t0:.1f} s on the host")
    runs = [("gcn xla", dict(model="gcn"), ("tt_fwd", "tt_grads")),
            ("gcn blocked", dict(model="gcn", spmm="blocked"),
             ("tt_fwd", "tt_grads", "spmm_gather")),
            ("gat", dict(model="gat"), ("tt_fwd", "tt_grads"))]
    losses, counts = {}, {}
    for label, kw, must in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = FullGraphConfig(**ARXIV, **kw)
        t0 = time.perf_counter()
        tr = FullGraphTrainer(ds, cfg, device=dev)
        what = (f"{cfg.num_layers} layers x {cfg.num_heads} heads x {cfg.hidden_dim}"
                if cfg.model == "gat" else f"{cfg.num_layers} layers x {cfg.hidden_dim}")
        if tr.blocked is not None:
            what += (f", window tiling {tr.blocked.fwd[0].numel()} tiles of {tr.blocked.tile} "
                     f"in {tr.blocked.fwd[0].shape[0]} chunks (transposed: "
                     f"{tr.blocked.bwd[0].numel()} tiles)")
        log(f"{label}: {what}, lr {cfg.lr} warmup {cfg.warmup_epochs}, dropout "
            f"{cfg.dropout}; trainer built in {time.perf_counter() - t0:.1f} s")
        reset_counts()
        losses[label] = []
        for e in range(STEPS_FULL):
            st = tr.train_epoch(e)
            log(f"  {label} step {e}: {st['epoch_time'] * 1e3:.1f} ms loss {st['loss']:.6f}")
            if not math.isfinite(st["loss"]):
                raise AssertionError(f"{label} step {e}: loss {st['loss']}")
            losses[label].append(st["loss"])
        counts[label] = launched()
        missing = [k for k in must if not counts[label].get(k)]
        log(f"  launches: {counts[label]}")
        if missing:
            raise AssertionError(f"{label}: {missing} never launched")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs = tr.evaluate()
        log(f"  {label} evaluate(): {(time.perf_counter() - t0) * 1e3:.0f} ms, {accs}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(0.0 <= a <= 1.0 for a in accs.values()):
            raise AssertionError(f"{label} evaluate() gave {accs}")
        del tr
    for a, b in zip(losses["gcn blocked"], losses["gcn xla"]):
        if not math.isclose(a, b, rel_tol=1e-3):
            raise AssertionError(f"gcn blocked losses {losses['gcn blocked']} vs xla "
                                 f"{losses['gcn xla']}")
    log(f"  gcn blocked losses within rtol 1e-3 of xla's: max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(losses['gcn blocked'], losses['gcn xla'])):.2e}")
    return counts


def sage_eval_routes(ds, config, state, xla_accs, dev):
    """Step 7: evaluate() of the f32 weights `state` through --spmm pallas
    (B7) and --spmm blocked (B9); the host tiling is timed apart.  Returns
    each route's FullGraphSpmm and the launch counts of its first
    evaluate()."""
    import torch
    from falcon_ttdforgnns_torch.train import SageTrainer
    spmms, counts = {}, {}
    for route, kernel in (("pallas", "spmm_tiled"), ("blocked", "spmm_gather")):
        tr = SageTrainer(ds, config(spmm=route), device=dev)
        tr.model.load_state_dict(state)
        sp = tr.full_graph_spmm(route)
        log(f"--spmm {route}: host tiling {sp.tiling_s:.1f} s, {sp.info}")
        accs, counts[route] = checked_evaluate(tr, f"--spmm {route} evaluate",
                                               ("tt_fwd", kernel))
        off = max(abs(accs[k] - xla_accs[k]) for k in accs)
        log(f"  accuracies within {off:.2e} of the xla route's (tol {SPMM_ROUTE_ACC})")
        if off > SPMM_ROUTE_ACC:
            raise AssertionError(f"--spmm {route} accuracies {accs} vs xla {xla_accs}")
        spmms[route] = sp
        del tr
        torch.cuda.empty_cache()
    return spmms, counts


def b8_profile_check(dev) -> bool:
    """One B8 call on the card is one memset and one kernel, with no
    per-tile partials and no index_add_: torch.profiler over one call on a
    random dst-sorted graph (200,000 nodes, 10M edges, D=100; the launches
    do not depend on the size).  It runs in a process of its own
    (in_own_process).  A missing record can only hide work, so any device
    work other than the memset and the tile_sum kernel fails at once, and a
    profile short of the two is taken again, up to three times.  Returns
    whether a profile was complete: main() takes a second process if not,
    and raises if that one's three are short too."""
    import torch
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    rng = np.random.default_rng(3)
    n, e = 200_000, 10_000_000
    flat = P.build_spmm_tiles(rng.integers(0, n, e).astype(np.int32),
                              np.sort(rng.integers(0, n, e)).astype(np.int32), n,
                              tile_edges=2048)
    args = (*(torch.as_tensor(a, device=dev) for a in (flat.src, flat.dstl, flat.w, flat.blk)),
            flat.num_blocks, flat.block_rows, flat.tile_edges, n)
    h = torch.randn((n, 100), device=dev)
    P.spmm_sum_tile_partials(h, *args)  # the first call loads the kernel

    def complete(ops):
        memsets = sum(c for k, (c, _) in ops.items() if "memset" in k.lower())
        kernels = {k: c for k, (c, _) in ops.items() if "memset" not in k.lower()}
        log(f"  one spmm_tile_partials call on the device: {memsets} memset(s), kernels "
            f"{ {k[:60]: c for k, c in kernels.items()} }")
        if memsets > 1 or any("tile_sum" not in k or c > 1 for k, c in kernels.items()):
            raise AssertionError(f"one B8 call should be one memset and one kernel: {ops}")
        return memsets == 1 and len(kernels) == 1

    return complete_profile(lambda: P.spmm_sum_tile_partials(h, *args), complete,
                            "one B8 call")[0] is not None


def param_offsets(a, b) -> tuple:
    """Two trainers' parameters apart: the largest share of a parameter's
    elements more than 0.1 lr apart, and the largest difference."""
    offs = [(x.detach() - y.detach()).abs() for x, y in zip(a.model.parameters(),
                                                            b.model.parameters())]
    return (max(float((o > 0.1 * LR).float().mean()) for o in offs),
            max(float(o.max()) for o in offs))


def dist_phase(ds, config, dev, counts) -> None:
    """--dist on the card (ROADMAP A8.1-A8.2): a one-rank NCCL group (a file
    store in a temporary directory) given to a trainer, so that it takes the
    data-parallel step (tt_grads, the all-reduce of every gradient with the
    loss and accuracy, then tt_adam_apply), against the single-device
    trainer (--dist at world size 1, as JAX's device_count() decides): the
    flagship (--mode puregpu --sparse --bf16, SAGE 3x256, batch 1024 at
    5,10,15).  Epoch 0 of STEPS_MAIN steps from the same seeds, the DP one
    counted, with a second single-device trainer beside them: how far the
    DP and the second run end from the first (tt_grads' atomics reorder its
    sums, and Adam's first steps, about lr * sign(g), carry a flipped sign
    of a near-cancelled element whole).  Then, as the flagship's checkpoint
    phase holds two card runs, the single-device state restored into the
    DP trainer and the next epoch on both, held at hold_params' bf16
    margins; then an epoch of each, timed (ms a step both ways), a profiled
    DP epoch (device busy, the all-reduce's records and bytes) and the
    all-reduce of one step's buffer alone, by CUDA events.  Fills
    counts["dist"]."""
    import tempfile
    import torch
    import torch.distributed as dist
    from falcon_ttdforgnns_torch.parallel import destroy_process_group, init_process_group
    from falcon_ttdforgnns_torch.train import SageTrainer
    must = ("tt_fwd[bf16]", "tt_grads[bf16]", "tt_adam_apply")
    cfg = config(mode="puregpu", sparse=True, bf16=True, steps_per_call=STEPS_MAIN, dist=True)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group("cuda", f"file://{tmp}/store", 0, 1,
                           local_rank=torch.cuda.current_device())
        try:
            log(f"  NCCL group: backend {dist.get_backend()}, world size {dist.get_world_size()}")
            one, two = (SageTrainer(cut(ds, STEPS_MAIN), cfg, device=dev) for _ in range(2))
            dp = SageTrainer(cut(ds, STEPS_MAIN), cfg, device=dev, group=dist.group.WORLD)
            if one.dp is not None or dp.dp is None or not dp.fused_sparse:
                raise AssertionError("--dist at world size 1 should be the single-device path, "
                                     "and a given group the fused data-parallel step")
            reset_counts()
            dstats = dp.train_epoch(0)
            counts["dist"] = checked_counts("dist (one NCCL rank)", must, STEPS_MAIN)
            single = [t.train_epoch(0)["loss"] for t in (one, two)]
            if (dp.step, one.step) != (STEPS_MAIN, STEPS_MAIN):
                raise AssertionError(f"dist: {dp.step} and {one.step} steps")
            (dshare, dmax), (tshare, tmax) = param_offsets(dp, one), param_offsets(two, one)
            log(f"  epoch 0 from the same seeds, losses: data-parallel {dstats['loss']:.6f}, "
                f"single-device {single[0]:.6f} and {single[1]:.6f}; parameters apart from the "
                f"first single-device run: data-parallel share > 0.1 lr {dshare:.4f}, max "
                f"{dmax:.3e}; the second single-device run {tshare:.4f}, max {tmax:.3e}")
            del two
            checkpoint_roundtrip(one, dp, "the single-device state into the data-parallel "
                                          "trainer")
            losses = [t.train_epoch(1)["loss"] for t in (one, dp)]
            hold_loss(dict(dist="epoch 1"), 1, losses[1], losses[0], True)
            hold_params(dict(dist="one NCCL rank", epoch=1), dp, one, True, steps=STEPS_MAIN,
                        where="products")
            # timed epochs in turns: single, DP, DP, single, ...
            ms = {one: [], dp: []}
            for e, turn in enumerate(((one, dp), (dp, one)) * 2, start=2):
                for tr in turn:
                    ms[tr].append(tr.train_epoch(e)["epoch_time"] * 1e3 / STEPS_MAIN)
            nbytes = dp.dp.reduced_bytes
            n_params = sum(p.numel() for p in dp.model.parameters())
            prof = {tr: device_ops(lambda: tr.train_epoch(6)) for tr in (one, dp)}
            buf = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
            ar_ms = cuda_ms(lambda: dist.all_reduce(buf), 20)
        finally:
            destroy_process_group()
    med = {tr: float(np.median(v)) for tr, v in ms.items()}
    log(f"  ms a step, 4 epochs each in turns (single-device first, then data-parallel first): "
        f"single-device {', '.join(f'{t:.2f}' for t in ms[one])} (median {med[one]:.2f}), "
        f"data-parallel over one NCCL rank {', '.join(f'{t:.2f}' for t in ms[dp])} (median "
        f"{med[dp]:.2f}, {med[dp] / med[one]:.3f}x)")
    (ops1, wall1, _), (opsd, walld, _) = prof[one], prof[dp]
    per_step = {k: tuple((c, round(t / STEPS_MAIN / 1e3, 4))
                         for c, t in (opsd.get(k, (0, 0)), ops1.get(k, (0, 0))))
                for k in {*opsd, *ops1}}
    extra = {k[:60]: v for k, v in per_step.items() if v[0][0] != v[1][0]}
    busy = {tr: sum(t for _, t in prof[tr][0].values()) / STEPS_MAIN / 1e3 for tr in prof}
    log(f"  the all-reduce: {nbytes} bytes a step ({n_params} parameters' gradients and the "
        f"loss and accuracy, f32); a profiled epoch each (profiler on): device busy "
        f"{busy[dp]:.3f} ms a step data-parallel against {busy[one]:.3f} single-device, wall "
        f"{walld / STEPS_MAIN / 1e3:.2f} against {wall1 / STEPS_MAIN / 1e3:.2f}; the records "
        f"whose counts differ, (count, device ms a step) data-parallel against single-device: "
        f"{extra}; the all-reduce alone, back to back, by CUDA events: {ar_ms:.4f} ms a call")
    del one, dp
    torch.cuda.empty_cache()


def c4_phase(ds, config, dev, counts) -> None:
    """ROADMAP C4 on the card: the mixed flagship (--sparse --bf16, sampled
    on the host) on a cut epoch of C4_BATCHES loader batches at
    --steps-per-call 8, the default: ceil(nb / 8) * 8 steps, the last group
    filled with the epoch's first batches, each step launching the path's
    kernels and sorting its ids once (counted).  Fills counts["c4"]."""
    import torch
    from falcon_ttdforgnns_torch.train import SageTrainer
    tr = SageTrainer(cut(ds, C4_BATCHES), config(sparse=True, bf16=True, steps_per_call=8),
                     device=dev)
    nb = len(tr.loader)
    want = -(-nb // 8) * 8
    reset_counts()
    stats = tr.train_epoch(0)
    log(f"  mixed flagship, a cut epoch of {nb} loader batches at --steps-per-call 8: "
        f"{tr.step} steps (ceil({nb} / 8) * 8 = {want}), loss {stats['loss']:.4f}, "
        f"{stats['epoch_time'] * 1e3 / tr.step:.1f} ms a step with the host sampling")
    counts["c4"] = checked_counts("c4", ("tt_fwd[bf16]", "tt_grads[bf16]", "tt_adam_apply"),
                                  want)
    if tr.step != want or any(counts["c4"][k] != want for k in ("tt_fwd[bf16]", "tt_grads[bf16]")):
        raise AssertionError(f"C4: {tr.step} steps, launches {counts['c4']}, want {want}")
    del tr
    torch.cuda.empty_cache()


def start_torchrun_cli(here: str, extra=()) -> tuple:
    """python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    falcon_ttdforgnns_torch.cli --dist --multihost --mode puregpu --sparse
    --bf16 --profile, an epoch of hard-ogbn-arxiv, in a process of its own,
    started after the timed phases (the dry run beside it times nothing);
    finish_torchrun_cli reads it.  Writes into a temporary directory.
    `extra` flags go last (a rehearsal on the CPU)."""
    import tempfile
    tmp = tempfile.mkdtemp()
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", "-m", "falcon_ttdforgnns_torch.cli", "--dist", "--multihost", "--mode",
            "puregpu", "--sparse", "--bf16", "--profile", "--profile-dir", f"{tmp}/prof",
            "--dataset", "hard-ogbn-arxiv", "--epochs", "1", "--log-every", "1000",
            "--ckpt-dir", f"{tmp}/ck", "--log-dir", f"{tmp}/logs", *extra]
    proc = subprocess.Popen(argv, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    CHILDREN.append(proc)
    return proc, tmp, time.perf_counter()


def finish_torchrun_cli(job) -> None:
    """Wait for start_torchrun_cli's process; raise unless it ended 0, its
    log names the nccl backend and world size 1, it printed its result, and
    its trace names tt_fwd's and tt_grads' kernels."""
    import glob
    import shutil
    proc, tmp, t0 = job
    try:
        out, err = proc.communicate(timeout=600)
        sec = time.perf_counter() - t0
        for line in err.splitlines():
            if any(k in line for k in ("multihost", "epoch 0", "Error", "error")):
                log(f"  | {line[-300:]}")
        if proc.returncode != 0:
            raise AssertionError(f"the torchrun CLI run failed ({proc.returncode}):\n"
                                 f"{err[-3000:]}")
        best = json.loads(out.strip().splitlines()[-1])
        traces = sorted(glob.glob(f"{tmp}/prof/trace_*.json"))  # not the spans_*.json
        named = []
        for t in traces:
            with open(t) as f:
                text = f.read()
            named.append("tt_fwd_kernel" in text and "tt_grads_kernel" in text)
        group = "process group backend nccl, world size 1" in err
        log(f"  torchrun --nproc-per-node 1 ... cli --dist --multihost --mode puregpu --sparse "
            f"--bf16 --profile on hard-ogbn-arxiv: rc 0 in {sec:.0f} s, {best}; the nccl group "
            f"of world size 1 logged: {group}; {len(traces)} traces "
            f"({[os.path.getsize(t) // 10**6 for t in traces]} MB) naming tt_fwd_kernel and "
            f"tt_grads_kernel: {named}")
        if set(best) != {"best"} or not group or not traces or not all(named):
            raise AssertionError("the torchrun CLI run left no result, group line or trace")
    finally:
        shutil.rmtree(tmp)


def dryrun_phase() -> None:
    """graft_entry on the card: entry()'s forward ((32, 8) finite logits)
    and dryrun_multichip(1), one spawned NCCL rank taking the data-parallel
    step, a grouped mixed epoch and a puregpu --sparse epoch."""
    import torch
    from falcon_ttdforgnns_torch import graft_entry
    fn, args = graft_entry.entry()
    out = fn(*args)
    if tuple(out.shape) != (32, 8) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"entry(): {tuple(out.shape)}")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(1)
    log(f"  entry() forward {tuple(out.shape)} on the card; dryrun_multichip(1) in "
        f"{time.perf_counter() - t0:.1f} s")


CHILDREN = []  # the processes start_own_process started, stopped when the script ends


def start_own_process(here: str, phase: str) -> subprocess.Popen:
    """chip_smoke.<phase>(cuda) started in a process of its own (see
    in_own_process); finish_own_process waits for it."""
    code = ("import json, torch, chip_smoke; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            f"print('RESULT ' + json.dumps(chip_smoke.{phase}(torch.device('cuda'))))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc


def finish_own_process(proc: subprocess.Popen, phase: str):
    """Wait for a phase of start_own_process, log its output, raise if it
    failed; returns what the phase returned, passed back as JSON on a line
    of its own."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    result = None
    for line in out.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
        else:
            log(line)
    if proc.returncode != 0 or not any(l.startswith("RESULT ") for l in out.splitlines()):
        raise AssertionError(f"{phase} failed in its own process:\n{err[-3000:]}")
    return result


def in_own_process(here: str, phase: str):
    """chip_smoke.<phase>(cuda) in a process of its own, whose output is
    logged; raises if it failed.  Returns what the phase returned.  Its
    torch.profiler sessions are then that process's first: on the H100,
    sessions taken after others in a process have lost device records of
    the port's kernels (PERF.md §7)."""
    return finish_own_process(start_own_process(here, phase), phase)


def b8_memory_check(call, out_bytes: int) -> None:
    """The peak memory one B8 call adds is its output's: no partials."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = call()
    rise = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    log(f"  spmm_tile_partials peak memory rise (bytes requested of the allocator) {rise} "
        f"for a {out_bytes}-byte output")
    if not out_bytes <= rise <= out_bytes + 4096:
        raise AssertionError(f"B8 allocated {rise} bytes for a {out_bytes}-byte output")
    del out


def spmm_kernel_phase(ds, spmms, dev):
    """Step 8: the SpMM kernels at the products shapes (the trainer's own
    tilings) against their plain versions, timed beside the plain version,
    a PyTorch library call and the xla route.  Bounds: compulsory bytes
    (h, the tiling's slots, out, each once) over 3.35 TB/s against useful
    f32 operations (2 per real edge and column for B7/B8, 1 multiply per
    message value for B9) over 67 TFLOP/s.  Returns per-kernel results and
    the phase's launch counts."""
    import torch
    from falcon_ttdforgnns_torch.ops import segment
    from falcon_ttdforgnns_torch.ops import spmm_blocked as B
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    n = ds.num_nodes
    src, dst = ds.graph.to_coo()
    E = len(src)
    gen = torch.Generator(device=dev).manual_seed(11)
    col = torch.as_tensor(ds.graph.indices.astype(np.int64), device=dev)
    crow = torch.as_tensor(ds.graph.indptr, device=dev)
    A = torch.sparse_csr_tensor(crow, col, torch.ones(E, device=dev), size=(n, n))
    dst_d = torch.as_tensor(dst.astype(np.int64), device=dev)
    sp = spmms["pallas"]
    info = sp.info
    log(f"SpMM kernels at the products graph: {E} edges; uniform tiling {info}")
    res, lib = {}, {}
    reset_counts()

    def record(name, err, ms, plain_ms, library_ms, nbytes, flops):
        b, by = bound_ms(nbytes, flops)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b, bound_by=by)
        lib_s = "none" if library_ms is None else f"{library_ms:.3f}"
        log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f}, library {lib_s}, bound "
            f"{b:.3f} ms by {by}: {b / ms:.1%} of it)")

    hs = {D: torch.randn((n, D), generator=gen, device=dev) for D in (100, 256)}
    t0 = time.perf_counter()
    flat = P.build_spmm_tiles(src.astype(np.int32), dst, n, tile_edges=sp.meta[3])
    args = (*(torch.as_tensor(a, device=dev) for a in (flat.src, flat.dstl, flat.w, flat.blk)),
            flat.num_blocks, flat.block_rows, flat.tile_edges, n)
    log(f"  flat tiling for B8: {flat.blk.size} tiles, {flat.src.size} slots, "
        f"{time.perf_counter() - t0:.1f} s on the host")
    b8_memory_check(lambda: P.spmm_sum_tile_partials(hs[100], *args), n * 100 * 4)

    for D in (100, 256):
        h = hs[D]
        err = check(f"spmm_tiled D={D}", [("out", sp(h), P.seg_mm_plain(
            h, *sp.arrays, *sp.meta[:4])[:n], "spmm_tiled")])
        ms = cuda_ms(lambda: sp(h), 5)
        plain_ms = cuda_ms(lambda: P.seg_mm_plain(h, *sp.arrays, *sp.meta[:4]), 1, warmup=0)
        lib[D] = cuda_ms(lambda: torch.sparse.mm(A, h), 5)
        xla = cuda_ms(lambda: segment.spmm_sum_chunked(h, col, dst_d, n), 2)
        log(f"  xla route (spmm_sum_chunked, index_add_) D={D}: {xla:.3f} ms")
        nbytes = 8 * n * D + 12 * info["slots"] + 4 * (info["tiles"] + info["chunks"])
        name = "spmm_tiled" if D == 256 else "spmm_tiled (D=100)"
        record(name, err, ms, plain_ms, lib[D], nbytes, 2 * E * D)
    h = hs[256]
    bf16 = torch.bfloat16
    got = P.spmm_sum_tiled_uniform(h, *sp.arrays, *sp.meta, compute_dtype=bf16)
    err = check("spmm_tiled[bf16] D=256", [("out", got, P.seg_mm_plain(
        h, *sp.arrays, *sp.meta[:4], compute_dtype=bf16)[:n], "spmm_tiled[bf16]")])
    f32 = sp(h)
    log(f"  bf16 compute against f32: max rel diff "
        f"{float((got - f32).abs().max() / f32.abs().max()):.2e}")
    del got, f32
    ms = cuda_ms(lambda: P.spmm_sum_tiled_uniform(h, *sp.arrays, *sp.meta,
                                                  compute_dtype=bf16), 5)
    plain_ms = cuda_ms(lambda: P.seg_mm_plain(h, *sp.arrays, *sp.meta[:4],
                                              compute_dtype=bf16), 1, warmup=0)
    try:  # the yardstick only: cuSPARSE may not take bf16
        A16 = torch.sparse_csr_tensor(crow, col, torch.ones(E, device=dev, dtype=bf16),
                                      size=(n, n))
        h16 = h.to(bf16)
        lib_bf16 = cuda_ms(lambda: torch.sparse.mm(A16, h16), 5)
        del A16, h16
    except RuntimeError as e:
        log(f"  torch.sparse.mm in bf16: {str(e).splitlines()[0][:120]}")
        lib_bf16 = None
    record("spmm_tiled[bf16]", err, ms, plain_ms, lib_bf16,
           8 * n * 256 + 12 * info["slots"] + 4 * (info["tiles"] + info["chunks"]),
           2 * E * 256)

    # B8 at D=100 is the f32 kernel's row and D=256 with bf16 compute the
    # bf16 one's; D=256 in f32 and bf16 show what its gather engine would
    # give B7 there
    for name, D, cd, library in (("spmm_tile_partials", 100, torch.float32, lib[100]),
                                 ("spmm_tile_partials (D=256)", 256, torch.float32, lib[256]),
                                 ("spmm_tile_partials[bf16]", 256, bf16, lib_bf16)):
        h = hs[D]

        def b8(h=h, cd=cd):
            return P.spmm_sum_tile_partials(h, *args, compute_dtype=cd)

        label = f"spmm_tile_partials D={D}{' bf16 compute' if cd == bf16 else ''}"
        err = check(label, [("out", b8(), P.tile_partials_plain(
            h, *args, compute_dtype=cd), name.split(" ")[0])])
        ms = cuda_ms(b8, 3)
        plain_ms = cuda_ms(lambda: P.tile_partials_plain(h, *args, compute_dtype=cd), 1,
                           warmup=0)
        record(name, err, ms, plain_ms, library,
               8 * n * D + 12 * flat.src.size + 4 * flat.blk.size, 2 * E * D)
    del args, flat

    bp = spmms["blocked"]
    win2, idx2, _, w2 = bp.arrays
    T, nc, D = bp.meta[0], win2.shape[0], 256
    h = hs[256]
    log(f"  window tiling {bp.info}: the gather of every chunk ({nc} launches)")
    for c in range(nc):
        if not torch.equal(B.window_gather(h, win2[c], idx2[c], w2[c], T),
                           B.window_gather_plain(h, win2[c], idx2[c], w2[c], T)):
            raise AssertionError(f"spmm_gather chunk {c} differs from its plain version")
    log(f"  spmm_gather D={D}: every message of every chunk bit-identical to the plain version")
    rows = [win2[c].long().repeat_interleave(T) * (T // 2) + idx2[c].long() for c in range(nc)]

    def gather_all(fn):
        for c in range(nc):
            fn(h, win2[c], idx2[c], w2[c], T)

    def library_gather():  # two calls a chunk; the rows computed outside the timing
        for c in range(nc):
            torch.mul(h.index_select(0, rows[c]), w2[c][:, None])

    record("spmm_gather", 0.0, cuda_ms(lambda: gather_all(B.window_gather), 3),
           cuda_ms(lambda: gather_all(B.window_gather_plain), 1, warmup=0),
           cuda_ms(library_gather, 3),
           4 * n * D + 8 * bp.info["slots"] + 4 * bp.info["tiles"] + 4 * bp.info["slots"] * D,
           bp.info["slots"] * D)
    return res, launched()


def cut(ds, steps):
    """The dataset with its train split cut to `steps` batches of 1024: an
    epoch of `steps` steps (depth, not width)."""
    return dataclasses.replace(ds, train_idx=ds.train_idx[:steps * 1024])


def main_path_phase(ds, config, K, dev, counts) -> list:
    """Step 6, the main path and the mixed flagship beside it (see the
    module's docstring); fills counts["main"] and returns the host-sampled
    batches of the other paths."""
    import torch
    from falcon_ttdforgnns_torch.models.sage import collect_level_ids
    from falcon_ttdforgnns_torch.train import SageTrainer
    # the main path: --mode puregpu --bf16 --sparse, one group of STEPS_MAIN
    # steps an epoch (one host-to-device copy of seeds and labels)
    cfg = config(mode="puregpu", sparse=True, bf16=True, steps_per_call=STEPS_MAIN)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = SageTrainer(cut(ds, STEPS_MAIN), cfg, device=dev)
    graph_bytes = trainer._indptr_dev.nbytes + trainer._indices_dev.nbytes
    log(f"main path: --mode puregpu --bf16 --sparse (bf16 kernel I/O, fused Adam), SAGE "
        f"{cfg.num_layers}x{cfg.hidden_dim}, epochs of {STEPS_MAIN} steps; trainer built in "
        f"{time.perf_counter() - t0:.1f} s, the CSR on the card {graph_bytes / 2**20:.0f} MiB "
        f"(device memory {(torch.cuda.memory_allocated() - before) / 2**20:.0f} MiB more)")
    kept = tap_sampler(trainer)
    must = ("tt_fwd[bf16]", "tt_grads[bf16]", "tt_adam_apply")
    counts["main"] = counted_epoch(trainer, 0, "puregpu bf16 sparse",
                                   must + ("fanout_mean_bf16", "fanout_mean_bf16[bwd]"),
                                   STEPS_MAIN)
    means = len(level_shapes(fanouts=cfg.fanouts))
    if (counts["main"]["fanout_mean_bf16"], counts["main"]["fanout_mean_bf16[bwd]"]) != (
            means * STEPS_MAIN, means * STEPS_MAIN):
        raise AssertionError(f"the main path's fan-out means: {counts['main']}, expected "
                             f"{means} forward and backward a step")
    main_ids = [collect_level_ids(sd, ls)[0].to(torch.int32) for sd, ls in kept]
    sampler_check(ds, trainer, kept, dev)
    cores = [c.detach() for c in trainer.cores]
    seed = torch.tensor(20261017, dtype=torch.int32, device=dev)
    for i, ids in enumerate(main_ids):
        walk, fwd_walk = walk_counts(K, trainer.shapes, ids)
        bound, by = grads_bound(trainer.shapes, walk, 2)
        fb, fby = fwd_bound(trainer.shapes, fwd_walk, 2)
        log(f"  {walk_line(f'step {i}', trainer.shapes, walk, fwd_walk)}; tt_fwd[bf16]'s "
            f"bound {fb:.4f} ms by {fby}, tt_grads' bound (bf16 d_out) {bound:.4f} ms by {by}")
        fwd_checks(K, trainer.shapes, cores, ids, seed, f" step {i}")
    del cores
    kept.clear()
    prof = profile_epoch(trainer, 1, STEPS_MAIN, K, main_ids[0])
    del trainer.sample_layers, kept  # the timed epoch runs the trainer as shipped
    seeds0 = main_ids[0][:cfg.batch_size]  # collect_level_ids puts the seeds first
    sample_dev = device_ms(lambda: trainer.sample_layers(seeds0))
    log(f"  the sampler alone, one step's tree: loop "
        f"{cuda_ms(lambda: trainer.sample_layers(seeds0), 20):.4f} ms, on the device "
        f"{'not measured' if sample_dev is None else f'{sample_dev:.4f} ms'} a call")
    stats = trainer.train_epoch(2)
    pure_ms = stats["epoch_time"] * 1e3 / STEPS_MAIN
    log(f"  puregpu epoch 2, timed: {pure_ms:.2f} ms per step, {stats['samples_per_s']:.0f} "
        f"seeds/s (device busy {prof['busy_ms'] or float('nan'):.3f} ms a step in the profiled "
        f"epoch, the sampler's kernels {prof['sample_ms'] or float('nan'):.3f} ms of it)")
    # beside it, on the same host: --mode mixed, sampled on the host
    mixed = SageTrainer(ds, config(sparse=True, bf16=True), device=dev)
    mixed_ms = host_sampled_steps(mixed, STEPS_MAIN, must)
    log(f"  seeds/s, puregpu against mixed: {1024 / pure_ms * 1e3:.0f} against "
        f"{1024 / mixed_ms * 1e3:.0f} ({mixed_ms / pure_ms:.1f}x)")
    t0 = time.perf_counter()
    other_b = [b for _, b in zip(range(STEPS_OTHER), mixed.loader)]
    log(f"sampled {len(other_b)} batches on the host for the other paths, "
        f"{(time.perf_counter() - t0) * 1e3 / len(other_b):.1f} ms per batch")
    del mixed
    chunk_sweep(K, trainer.shapes, main_ids, dev)
    del main_ids
    log("evaluate() under bf16: full-graph propagation over every node and edge (layer 1's "
        "f32 mean through csr_mean_f32, layer 2's bf16 mean through segment_mean_bf16, layer "
        "3's after its product, 47 classes padded to 48, through csr_mean_bf16)")
    full_accs, counts["bf16 evaluate"] = checked_evaluate(
        trainer, "bf16 evaluate",
        must_launch=("tt_fwd", "csr_mean_f32", "segment_mean_bf16", "csr_mean_bf16"))
    flagship_tools_phase(trainer, ds, full_accs, dev, counts)
    del trainer
    torch.cuda.empty_cache()
    return other_b


def table_phase(ds, config, dev, counts) -> None:
    """Step 6, --sampler table: STEPS_OTHER steps twice, the table's host
    build and device memory; fills counts["table"]."""
    import torch
    from falcon_ttdforgnns_torch.train import SageTrainer
    must = ("tt_fwd[bf16]", "tt_grads[bf16]", "tt_adam_apply")
    log(f"{STEPS_OTHER} steps of --mode puregpu --sampler table --table-width 32 "
        f"--bf16 --sparse, twice")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    table_tr = SageTrainer(cut(ds, STEPS_OTHER), config(
        mode="puregpu", sampler="table", table_width=32, sparse=True, bf16=True,
        steps_per_call=STEPS_OTHER), device=dev)
    built_s = time.perf_counter() - t0
    log(f"  trainer built in {built_s:.1f} s (the table built on the host and placed), the "
        f"table {table_tr._table_dev.nbytes / 2**20:.0f} MiB on the card "
        f"({tuple(table_tr._table_dev.shape)} int32; device memory "
        f"{(torch.cuda.memory_allocated() - before) / 2**20:.0f} MiB more with the CSR)")
    kept = tap_sampler(table_tr)
    counts["table"] = counted_epoch(table_tr, 0, "puregpu table", must, STEPS_OTHER)
    sampler_check(ds, table_tr, kept, dev)
    del table_tr.sample_layers, kept  # the timed epoch runs the trainer as shipped
    stats = table_tr.train_epoch(1)
    log(f"  --sampler table epoch 1, timed: {stats['epoch_time'] * 1e3 / STEPS_OTHER:.2f} ms "
        f"per step, {stats['samples_per_s']:.0f} seeds/s")
    del table_tr
    torch.cuda.empty_cache()


def start_partition(graph, k: int):
    """--partition k of `graph` in a thread (the native partitioner runs
    without the GIL), beside the phases that follow: (thread, result), and
    after the thread ends result holds "perm" and "s", its host seconds, or
    "error", which join_partition raises."""
    import threading
    from falcon_ttdforgnns_torch.graph import reorder
    result = {}

    def run():
        t0 = time.perf_counter()
        try:
            result["perm"] = reorder.reorder_permutation(graph, k, seed=0)
        except Exception as e:  # raised again by join_partition, in the main thread
            result["error"] = e
        result["s"] = time.perf_counter() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, result


def join_partition(job) -> tuple:
    """Wait for start_partition's thread: (permutation, host seconds)."""
    th, result = job
    th.join()
    if "error" in result:
        raise result["error"]
    return result["perm"], result["s"]


def arxiv_orderings(dev):
    """Step (a) at arxiv: --partition -1 (recursive, matched to the arxiv
    preset's p-shapes) and -4 (label propagation, then k-way within
    clusters) on the full-size hard-ogbn-arxiv graph, host seconds; run in a
    process of its own beside the products orderings.  Both loop in Python
    over segments and nodes and do not finish at products size in either
    package."""
    from falcon_ttdforgnns_torch.graph import get_dataset, reorder
    ds = get_dataset("hard-ogbn-arxiv", seed=0)
    secs = {}
    for code in (-1, -4):
        t0 = time.perf_counter()
        perm = reorder.reorder_permutation(ds.graph, code, levels=list(ARXIV["p_shapes"]),
                                           seed=0)
        secs[code] = time.perf_counter() - t0
        if not np.array_equal(np.sort(perm), np.arange(ds.num_nodes)):
            raise AssertionError(f"--partition {code} gave no permutation")
        log(f"  --partition {code} on hard-ogbn-arxiv ({ds.num_nodes} nodes, "
            f"{ds.graph.num_edges} edges): {secs[code]:.1f} s on the host")
    return secs


def orderings_phase(ds0, perms: dict, K, dev) -> None:
    """Step (a), the locality each ordering buys the port's own kernels: one
    flagship batch (1024 seeds, fan-out 5,10,15) sampled on the products
    graph in its generator's order, relabelled by each ordering's
    permutation (a relabelled sample of a graph is a sample of the
    relabelled graph), and beside them as many uniform random ids: the
    distinct ids and prefix runs that set tt_fwd's and tt_grads' work, and
    their loop ms (f32, the sort given; the sort apart)."""
    import torch
    from falcon_ttdforgnns_torch.graph import sampler
    from falcon_ttdforgnns_torch.ops import tt_init
    from falcon_ttdforgnns_torch.ops.tt_shapes import make_tt_shapes
    shapes = make_tt_shapes(ds0.num_nodes, 100, (16, 16), (125, 140, 140), (5, 5, 4))
    cores = [torch.tensor(c, device=dev)
             for c in tt_init.init_tt_cores(shapes, "approx-normal", 0)]
    rng = np.random.default_rng(3)
    # the flagship's batch, and one of 16 seeds: 17,500 prefixes, so a
    # batch of 937,984 ids may touch every one of them whatever the order
    for n_seeds in (1024, 16):
        ids0 = sampler.sample_block(ds0.graph, rng.choice(ds0.train_idx, n_seeds, replace=False),
                                    (5, 10, 15), rng).all_nodes.astype(np.int64)
        d = torch.randn((len(ids0), shapes.embedding_dim),
                        generator=torch.Generator(device=dev).manual_seed(2), device=dev)
        log(f"  one batch of {n_seeds} seeds, {len(ids0)} ids:")
        rows = [("the generator's order", ids0),
                *((f"--partition {code}", perm[ids0]) for code, perm in perms.items()),
                ("uniform random ids", rng.integers(0, ds0.num_nodes, len(ids0)))]
        for label, ids in rows:
            t = torch.tensor(ids.astype(np.int32), device=dev)
            walk = K.grouped_counts(shapes, t)
            order = K.grouped_order(t)
            fwd = cuda_ms(lambda: K.tt_fwd(shapes, cores, t, order=order), 10)
            grads = cuda_ms(lambda: K.tt_grads(shapes, cores, t, d, order=order), 10)
            srt = cuda_ms(lambda: K.grouped_order(t), 10)
            log(f"    {label}: {walk['distinct']} distinct ids, {walk['prefix_runs']} prefix "
                f"runs; tt_fwd {fwd:.4f} ms, tt_grads {grads:.4f} ms a call (f32, the sort "
                f"given), the sort {srt:.4f} ms")


def top_k_ids(freq: np.ndarray, k: int) -> np.ndarray:
    """The id table a populate should build from the counts `freq`: the k
    most counted ids, the lower id first among equal counts
    (jax.lax.top_k's order), -1 where the count is 0, sorted."""
    top = np.argsort(-freq.astype(np.int64), kind="stable")[:k]
    return np.sort(np.where(freq[top] > 0, top, -1))


def hit_shares(meta, id_batches) -> list:
    """The share of each batch's ids that the cache serves."""
    from falcon_ttdforgnns_torch.ops import cache
    return [float(cache.lookup(meta, ids)[0].float().mean()) for ids in id_batches]


def checked_populate(trainer, label: str, freq: np.ndarray, K) -> float:
    """trainer.maybe_populate_cache(), timed: raise unless the id table is
    the top CACHE_K of `freq` and the rows, from tt_fwd in chunks, agree with
    the plain chain's (TOL["tt_fwd"]).  Returns the seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.maybe_populate_cache()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    emb = trainer.model.embed
    ids = emb.cache_ids
    if not np.array_equal(ids.cpu().numpy(), top_k_ids(freq, CACHE_K)):
        raise AssertionError(f"{label}: the cached ids are not the {CACHE_K} most counted")
    log(f"  {label} populate: {secs:.3f} s, {int((ids >= 0).sum())} rows, the least "
        f"cached count {int(freq[int(ids[ids >= 0][0])]) if bool((ids >= 0).any()) else 0}")
    check(f"{label} populate", [("rows", emb.cache_weight.detach(), K.tt_fwd_plain(
        trainer.shapes, [c.detach() for c in trainer.cores], torch.clamp(ids, min=0)),
        "tt_fwd")])
    return secs


def timed_methods(obj, names) -> dict:
    """Wrap each named method of `obj` in an instance attribute that
    appends each call's host ms to the returned dict's list for it;
    `delattr(obj, name)` restores the class's method."""
    spent = {n: [] for n in names}
    for n in names:
        def timed(*a, _fn=getattr(obj, n), _n=n, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spent[_n].append((time.perf_counter() - t0) * 1e3)
        setattr(obj, n, timed)
    return spent


def final_p_phase(ds, config, K, dev, counts) -> None:
    """Step (b), the slice's path: the README's final-p (--partition 128
    --use-cached --cache-size 100000, f32, routed Adam, --mode mixed through
    the native sampler) on the 128-partitioned products graph.  With the
    launch counters zeroed before and read after: FINAL_P_WARMUP warmup
    steps through train_epoch (the host loader counting accesses), the
    populate (its id table and rows checked), FINAL_P_CACHED cached steps on
    fresh train seeds with each step's hit share, and evaluate() (hits read
    from the cache).  Then a trainer without the cache takes the same
    warmup and the same cached batches: ms a step with and without the
    cache.  Before it all, the native sampler's ms a batch beside the numpy
    sampler's, on this host and graph; the warmup steps' host time is cut
    into the loader's sampling, its access counting, the train_step call
    and the rest of the epoch loop."""
    import torch
    from falcon_ttdforgnns_torch.graph import sampler
    from falcon_ttdforgnns_torch.train import SageTrainer
    from falcon_ttdforgnns_torch.utils.metrics import access_percentages
    W, C = FINAL_P_WARMUP, FINAL_P_CACHED
    picks = np.random.default_rng(8).permutation(ds.train_idx)
    warm, fresh = np.sort(picks[:W * 1024]), np.sort(picks[W * 1024:(W + C) * 1024])
    rng = np.random.default_rng(9)

    def sample_ms(n):
        out = []
        for _ in range(n):
            seeds = rng.choice(ds.train_idx, 1024, replace=False)
            t0 = time.perf_counter()
            sampler.sample_block(ds.graph, seeds, (5, 10, 15), rng)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    native = sample_ms(5)
    handle, sampler._native = sampler._native, None
    try:
        numpy_path = sample_ms(3)
    finally:
        sampler._native = handle
    log(f"  host sampler, one batch of {IDS_PER_STEP} ids on the 128-partitioned graph: native "
        f"{', '.join(f'{t:.1f}' for t in native)} ms, numpy "
        f"{', '.join(f'{t:.1f}' for t in numpy_path)} ms")
    cfg = config(cache_size=CACHE_K, steps_per_call=FINAL_P_GROUP)
    t0 = time.perf_counter()
    tr = SageTrainer(dataclasses.replace(ds, train_idx=warm), cfg, device=dev)
    log(f"  final-p trainer built in {time.perf_counter() - t0:.1f} s; {W} warmup steps on "
        f"{W * 1024} random train seeds, then {C} cached steps on {C * 1024} others")
    must = ("tt_fwd", "tt_grads")
    reset_counts()
    loader_ms = timed_methods(tr.loader, ("_make_batch", "_count"))
    step_ms = timed_methods(tr, ("train_step",))
    stats = tr.train_epoch(0)
    warm_counts = launched()
    for obj, names in ((tr.loader, loader_ms), (tr, step_ms)):
        for n in names:
            delattr(obj, n)
    parts = {"sampling": loader_ms["_make_batch"], "access counting": loader_ms["_count"],
             "the train_step call": step_ms["train_step"]}
    wall = stats["epoch_time"] * 1e3 / W
    rest = wall - sum(float(np.mean(v)) for v in parts.values())
    log(f"  warmup steps' host time apart, mean (median; first step) ms a step of "
        f"{wall:.1f}: " + ", ".join(f"{k} {np.mean(v):.2f} ({np.median(v):.2f}; {v[0]:.2f})"
                                    for k, v in parts.items())
        + f", the rest of the loop {rest:.2f} (the train_step call holds the host-to-device "
        f"copies, which wait for the previous step's device work, and the launches)")
    freq = tr.loader.freq.copy()
    skew = list(access_percentages(freq).values())[:3]  # the hottest 1%, 5%, 10% of rows
    log(f"  warmup epoch: {stats['epoch_time'] * 1e3 / W:.1f} ms a step (host sampling + "
        f"step), {stats['samples_per_s']:.0f} seeds/s, loss {stats['loss']:.4f}; launches "
        f"{warm_counts}; {int(freq.sum())} accesses counted on the host, the hottest 1%/5%/10% "
        f"of rows serve {', '.join(f'{v:.1%}' for v in skew)}")
    if int(freq.sum()) != W * IDS_PER_STEP or any(warm_counts.get(k) != W for k in must):
        raise AssertionError(f"final-p warmup: {int(freq.sum())} accesses, launches {warm_counts}")
    checked_populate(tr, "final-p", freq, K)
    batches = [b for _, b in zip(range(C), sampler.NeighborLoader(
        ds.graph, fresh, ds.labels, cfg.fanouts, cfg.batch_size, seed=1))]
    hits = hit_shares(tr.model.embed.cache_meta, [collect_ids(b)[0].to(dev) for b in batches])
    cached = train_steps(tr, batches, "final-p cached")
    before_eval = launched()
    log("  final-p evaluate() (hits read from the cache):")
    _, eval_counts = checked_evaluate(tr, "final-p evaluate")  # zeroes the counts first
    counts["final-p"] = {k: before_eval.get(k, 0) + eval_counts.get(k, 0)
                         for k in {*before_eval, *eval_counts}}
    log(f"  final-p launches, warmup to evaluate: {counts['final-p']}")
    missing = [k for k in must if not counts["final-p"].get(k)]
    if missing:
        raise AssertionError(f"final-p: {missing} never launched")
    log(f"  hit share of the cached steps: {', '.join(f'{h:.2%}' for h in hits)}")
    fresh = SageTrainer(dataclasses.replace(ds, train_idx=warm), cfg, device=dev)
    checkpoint_roundtrip(tr, fresh, "final-p (cache rows, metadata, rowwise accumulator)")
    for t in (tr, fresh):  # as the next epoch's start reseeds it (train_epoch)
        t.dropout_gen.manual_seed(cfg.seed + 1000 + 2)
    for i, b in enumerate(batches[:CKPT_STEPS]):
        la, _ = tr.train_step(b.seeds, b.layers, b.labels)
        lb, _ = fresh.train_step(b.seeds, b.layers, b.labels)
        hold_loss(dict(final_p="restored"), i, lb, la, False)
    # the losses at the f32 margin, the parameters at the margin of two runs
    # whose normalised updates round apart (hold_params' bf16 branch): the
    # cache rows' rowwise adagrad divides by each row's own gradient so far
    # (sqrt(acc) ~2e-7 at the median row, scripts/restore_drift.py), so a
    # row whose gradient is a near-cancelled sum of hits steps elsewhere when
    # the atomics of the card's index_add_ order the sum otherwise, and the
    # Adam parameters follow through the forward (0.0095-0.81 lr apart over
    # runs, up to 33 rows)
    hold_params(dict(final_p="restored"), fresh, tr, True, steps=CKPT_STEPS, where="products")
    del tr, fresh
    plain = SageTrainer(dataclasses.replace(ds, train_idx=warm),
                        config(steps_per_call=FINAL_P_GROUP), device=dev)
    plain.train_epoch(0)
    uncached = train_steps(plain, batches, "final-p without the cache")
    del plain
    torch.cuda.empty_cache()
    c_ms = float(np.median([m for m, _ in cached]))
    u_ms = float(np.median([m for m, _ in uncached]))
    s_ms = float(np.median(native))
    log(f"  does the cache pay: median step {c_ms:.2f} ms with it, {u_ms:.2f} ms without "
        f"({c_ms / u_ms:.3f}x); with the native sampler's {s_ms:.1f} ms a batch, "
        f"{1024 / (c_ms + s_ms) * 1e3:.0f} against {1024 / (u_ms + s_ms) * 1e3:.0f} seeds/s")


def puregpu_cache_phase(ds, config, K, dev, counts) -> None:
    """Step (c), the flagship with the cache: --mode puregpu --bf16 --sparse
    --use-cached --cache-size 100000 (the fused update off, as JAX's
    _want_fused_sparse decides; the lookup f32 through TTLookup), depth cut
    to an epoch of PUREGPU_CACHE_STEPS steps: the warmup epoch, counted on
    the card (device_freq), the populate from those counts, and a cached
    epoch on fresh seeds, each with the counters zeroed before and read
    after, and each cached step's hit share."""
    import torch
    from falcon_ttdforgnns_torch.models.sage import collect_level_ids
    from falcon_ttdforgnns_torch.train import SageTrainer
    S = PUREGPU_CACHE_STEPS
    picks = np.random.default_rng(10).permutation(ds.train_idx)
    warm, fresh = np.sort(picks[:S * 1024]), np.sort(picks[S * 1024:2 * S * 1024])
    cfg = config(mode="puregpu", sparse=True, bf16=True, cache_size=CACHE_K,
                 steps_per_call=S)
    tr = SageTrainer(dataclasses.replace(ds, train_idx=warm), cfg, device=dev)
    if tr.fused_sparse or not tr.model.embed.device_freq:
        raise AssertionError("puregpu + cache: the update should be routed, the counts the card's")
    must = ("tt_fwd", "tt_grads")
    counts["puregpu cache warmup"] = counted_epoch(tr, 0, "puregpu cache warmup", must, S)
    freq = tr.model.embed.cache_freq.cpu().numpy()
    if int(freq.sum()) != S * IDS_PER_STEP:
        raise AssertionError(f"puregpu cache: {int(freq.sum())} accesses counted on the card")
    checked_populate(tr, "puregpu cache", freq, K)
    tr.ds = dataclasses.replace(tr.ds, train_idx=fresh)
    kept = tap_sampler(tr)
    counts["puregpu cache"] = counted_epoch(tr, 1, "puregpu cache", must, S)
    hits = hit_shares(tr.model.embed.cache_meta,
                      [collect_level_ids(sd, ls)[0] for sd, ls in kept])
    del tr.sample_layers, kept
    log(f"  hit share of the cached steps: {', '.join(f'{h:.2%}' for h in hits)}")
    del tr
    torch.cuda.empty_cache()


def small_cache_check(dev):
    """Step (d): final-p's lifecycle on the card against the CPU (plain
    versions) on a tiny graph, dropout off: 3 warmup steps, the populate
    from the host counts, 3 cached steps, in f32 and under --bf16 (each
    with --sparse, which the cache turns into the routed update).  The card
    must cache the ids the CPU caches; the losses and parameters (the cache
    rows too) are held as small_step_check holds them, f32 but for at most
    FULL_GRAPH_OUTLIERS of each parameter's elements past 3e-3 lr, none
    past FLAT_ADAM_TOL lr (Adam on a near-cancelled gradient element)."""
    import torch
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5,
                                feat_dim=64, seed=1)
    for kw in (dict(sparse=True, cache_size=512), dict(sparse=True, bf16=True, cache_size=512)):
        cfg = TrainConfig(batch_size=128, fanouts=(3, 4), hidden_dim=32, num_layers=2,
                          tt_ranks=(8, 8), dropout=0.0, seed=1, lr=LR, **kw)
        gpu, cpu = SageTrainer(ds, cfg, device=dev), SageTrainer(ds, cfg, device="cpu")
        batches = iter(cpu.loader)
        hits = []
        for step in range(6):
            if step == 3:
                gpu.loader.freq = cpu.loader.freq.copy()
                gpu.maybe_populate_cache()
                cpu.maybe_populate_cache()
                if not torch.equal(gpu.model.embed.cache_ids.cpu(), cpu.model.embed.cache_ids):
                    raise AssertionError(f"{kw}: the card caches other ids than the CPU")
            b = next(batches)
            if step >= 3:
                hits += hit_shares(cpu.model.embed.cache_meta, [collect_ids(b)[0]])
            lc, _ = cpu.train_step(b.seeds, b.layers, b.labels)
            lg, _ = gpu.train_step(b.seeds, b.layers, b.labels)
            hold_loss(kw, step, lg, lc, cfg.bf16)
        log(f"  tiny graph {kw}: the same {int((cpu.model.embed.cache_ids >= 0).sum())} ids "
            f"cached on both, hit shares {', '.join(f'{h:.1%}' for h in hits)}")
        if cfg.bf16:
            hold_params(kw, gpu, cpu, True, steps=6)
            continue
        offs = [(a.detach().cpu() - b.detach()).abs()
                for a, b in zip(gpu.model.parameters(), cpu.model.parameters())]
        tol = 3 * 1e-3 * LR
        share = max(float((o > tol).float().mean()) for o in offs)
        err = max(float(o.max()) for o in offs)
        ok = share <= FULL_GRAPH_OUTLIERS and err <= FLAT_ADAM_TOL * LR
        log(f"  tiny graph {kw}: 6 steps, loss ok, max param diff {err:.3e} (tol "
            f"{FLAT_ADAM_TOL * LR:.1e}), largest share past {tol:.1e} {share:.2e} (tol "
            f"{FULL_GRAPH_OUTLIERS:.0e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{kw}: params on the card and on the CPU disagree")


def level_shapes(B: int = 1024, fanouts=(5, 10, 15), dims=(100, 256, 256)) -> list:
    """The (B, n, f, d) inputs of the conv tower's fan-out means in one step
    of SAGE 3 x 256 at --fan-out 5,10,15: layer l means the levels left
    after it, the seeds' level first (3 + 2 + 1 means)."""
    widths = [1]
    for f in reversed(fanouts):
        widths.append(widths[-1] * f)
    return [(B, widths[lev], widths[lev + 1] // widths[lev], dims[li])
            for li in range(len(fanouts)) for lev in range(len(fanouts) - li)]


def tower_kernel_check(dev) -> dict:
    """The bf16 fan-out mean's kernels (forward and backward, the port's own:
    the reference takes this mean as an XLA reduction) against their plain
    versions on the flagship's six level shapes, normal and large values,
    bit for bit; then the six calls of one step timed, kernel against plain
    version, beside PyTorch's bf16 mean (another function: f32
    accumulation, so no library time).  Returns per-kernel results."""
    import torch
    from falcon_ttdforgnns_torch.ops import tower
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = level_shapes()
    xs = [torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16) for sh in shapes]
    gs = [torch.randn(sh[:2] + sh[3:], generator=gen, device=dev).to(torch.bfloat16)
          for sh in shapes]
    worst = dict.fromkeys(tower.KERNELS, 0.0)
    for scale in (1.0, 3e4):
        for sh, x, g in zip(shapes, xs, gs):
            x, g = (x.float() * scale).to(torch.bfloat16), (g.float() * scale).to(torch.bfloat16)
            for name, got, want in (
                    ("fanout_mean_bf16", tower.fanout_mean_bf16_fwd(x),
                     tower.fanout_mean_bf16_plain(x)),
                    ("fanout_mean_bf16[bwd]", tower.fanout_mean_bf16_bwd(g, sh[2]),
                     tower.fanout_mean_bf16_bwd_plain(g, sh[2]))):
                if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                    raise AssertionError(f"{name} at {sh}, scale {scale}: not bit-identical "
                                         f"to its plain version")
                worst[name] = max(worst[name], float((got.float() - want.float()).abs().max()))
    log(f"  fanout_mean_bf16 and its backward bit-identical to their plain versions at "
        f"{shapes}, values N(0, 1) and N(0, 3e4^2)")
    n_in = sum(math.prod(sh) for sh in shapes)            # (B, n, f, d) values
    n_out = sum(math.prod(sh[:2] + sh[3:]) for sh in shapes)  # (B, n, d)
    fs = [sh[2] for sh in shapes]
    res = {"fanout_mean_bf16": dict(
        max_abs_err=worst["fanout_mean_bf16"],
        ms=cuda_ms(lambda: [tower.fanout_mean_bf16_fwd(x) for x in xs], 20),
        plain_ms=cuda_ms(lambda: [tower.fanout_mean_bf16_plain(x) for x in xs], 3),
        library_ms=None), "fanout_mean_bf16[bwd]": dict(
        max_abs_err=worst["fanout_mean_bf16[bwd]"],
        ms=cuda_ms(lambda: [tower.fanout_mean_bf16_bwd(g, f) for g, f in zip(gs, fs)], 20),
        plain_ms=cuda_ms(lambda: [tower.fanout_mean_bf16_bwd_plain(g, f)
                                  for g, f in zip(gs, fs)], 3),
        library_ms=None)}
    # bf16 in and out once each; f32 operations: f adds and the division
    # an output (forward), one division a value (backward)
    for name in tower.KERNELS:
        res[name]["bound_ms"], res[name]["bound_by"] = bound_ms(2 * (n_in + n_out), n_in)
    torch_mean = cuda_ms(lambda: [x.mean(dim=2) for x in xs], 20)
    for name, r in res.items():
        log(f"  {name}, one step's six means: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    log(f"  PyTorch's bf16 mean on the same inputs (f32 accumulation, not the reference's "
        f"bits): {torch_mean:.4f} ms")
    return res


def state_bytes(trainer) -> int:
    """Bytes of the trainer's parameters and optimizer state (every
    tensor of checkpoint_state's opt_state)."""
    import torch
    ts = list(trainer.model.parameters())

    def walk(o):
        if isinstance(o, torch.Tensor):
            ts.append(o)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)

    walk(trainer.checkpoint_state()[1])
    return sum(t.numel() * t.element_size() for t in ts)


def baseline_phase(ds, config, dev, counts) -> None:
    """The README's baseline preset (scripts/run_presets.sh): --no-tt, the
    dense 2,449,029 x 100 f32 table, routed Adam, f32: STEPS_MAIN steps in
    --mode mixed (the preset's mode; host-sampled as train_epoch does),
    then --mode puregpu epochs of STEPS_MAIN steps (counted, profiled,
    timed) and evaluate(); then the TT flagship in f32 (--sparse, fused
    Adam) on the same puregpu batches.  ms a step, seeds/s, device busy a
    step, peak memory, and the bytes of parameters and optimizer state of
    each: the TT-against-dense comparison on one card."""
    import torch
    from falcon_ttdforgnns_torch.train import SageTrainer
    S = STEPS_MAIN
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mixed = SageTrainer(ds, config(use_tt=False), device=dev)
    table = mixed.model.embed.weight
    log(f"baseline --no-tt, --mode mixed: trainer built in {time.perf_counter() - t0:.1f} s, "
        f"the table {tuple(table.shape)} f32 {table.numel() * 4 / 1e6:.1f} MB; parameters and "
        f"optimizer state {state_bytes(mixed) / 1e9:.3f} GB")
    host_sampled_steps(mixed, S, ())
    del mixed, table
    rows = {}
    for key, label, kw in (("baseline", "baseline --no-tt", dict(use_tt=False)),
                           ("tt f32", "the TT flagship in f32 (--sparse, fused Adam)",
                            dict(sparse=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = SageTrainer(cut(ds, S), config(mode="puregpu", steps_per_call=S, **kw), device=dev)
        reset_counts()
        stats = tr.train_epoch(0)
        counts[key] = launched()
        if not math.isfinite(stats["loss"]):
            raise AssertionError(f"{label}: loss {stats['loss']}")

        def complete(ops):
            if key == "baseline":
                return sum(c for c, _ in ops.values()) >= 10 * S
            tt = [c for k, (c, _) in ops.items() if "tt_fwd_kernel" in k or "tt_grads_kernel" in k]
            return sorted(tt) == [S, S]

        ops, wall_us, _ = complete_profile(lambda: tr.train_epoch(1), complete,
                                           f"a {S}-step {label} epoch")
        busy = None if ops is None else sum(us for _, us in ops.values()) / S / 1e3
        stats = tr.train_epoch(2)
        ms = stats["epoch_time"] * 1e3 / S
        rows[key] = (ms, stats["samples_per_s"], busy, torch.cuda.max_memory_allocated(),
                     state_bytes(tr))
        log(f"  {label}, --mode puregpu: {ms:.2f} ms a step, {stats['samples_per_s']:.0f} "
            f"seeds/s, device busy {'not measured' if busy is None else f'{busy:.3f} ms'} a "
            f"step, peak device memory {rows[key][3] / 2**30:.2f} GiB, parameters and "
            f"optimizer state {rows[key][4] / 1e6:.1f} MB; launches {counts[key]}")
        if key == "baseline":
            checked_evaluate(tr, "baseline evaluate", must_launch=())
        del tr
    (bm, bs, _, bp, bb), (tm, ts, _, tp, tb) = rows["baseline"], rows["tt f32"]
    log(f"  TT against dense on one card, f32, the same puregpu batches: {tm:.2f} against "
        f"{bm:.2f} ms a step ({ts:.0f} against {bs:.0f} seeds/s), state {tb / 1e6:.1f} against "
        f"{bb / 1e6:.1f} MB ({bb / tb:.0f}x), peak memory {tp / 2**30:.2f} against "
        f"{bp / 2**30:.2f} GiB")
    torch.cuda.empty_cache()


def small_new_paths_check(dev) -> None:
    """--no-tt --access-counts sampled steps, and --full-neighbor with TT
    (--sparse, which full-neighbor turns into routed Adam) and with --no-tt,
    on the tiny graph, card against CPU (plain versions), dropout off: 3
    steps each on the same batches or seeds, held as small_puregpu_check
    holds f32 steps (an element whose Adam step was not normalised on
    either side to FLAT_ADAM_TOL); the access counts equal."""
    import torch
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5,
                                feat_dim=64, seed=1)
    for kw in (dict(use_tt=False, access_counts=True), dict(use_sample=False, sparse=True),
               dict(use_sample=False, use_tt=False)):
        cfg = TrainConfig(batch_size=128, fanouts=(3, 4), hidden_dim=32, num_layers=2,
                          tt_ranks=(8, 8), dropout=0.0, seed=1, lr=LR, **kw)
        gpu, cpu = SageTrainer(ds, cfg, device=dev), SageTrainer(ds, cfg, device="cpu")
        flat = None
        batches = iter(cpu.loader)
        for step in range(3):
            if cfg.use_sample:
                b = next(batches)
                lg, _ = gpu.train_step(b.seeds, b.layers, b.labels)
                lc, _ = cpu.train_step(b.seeds, b.layers, b.labels)
            else:
                seeds = torch.as_tensor(ds.train_idx[step * 128:(step + 1) * 128]
                                        .astype(np.int64))
                lg, _ = gpu.full_neighbor_step(seeds.to(dev))
                lc, _ = cpu.full_neighbor_step(seeds)
            hold_loss(kw, step, lg, lc, False)
            now = [a | b for a, b in zip(adam_flat(gpu), adam_flat(cpu))]
            flat = now if flat is None else [a | b for a, b in zip(flat, now)]
        hold_params(kw, gpu, cpu, False, flat)
        if cfg.access_counts and not torch.equal(gpu.model.embed.counts.cpu(),
                                                 cpu.model.embed.counts):
            raise AssertionError(f"{kw}: the access counts differ")


def full_neighbor_phase(ds, config, K, dev, counts) -> None:
    """--full-neighbor SAGE 3 x 256 on the full-size products graph (TT
    p=125,140,140 q=5,5,4 ranks 16,16, f32, routed Adam, batch 1024):
    STEPS_FULL_NEIGHBOR steps through train_epoch with the launch counters
    zeroed before and read after (tt_fwd over all 2,449,029 ids and
    tt_grads in its backward, once each a step; one sort a step), their
    ms and peak memory; one step profiled for the kernels' device time;
    both kernels at this shape (every id once, sorted) timed against their
    plain versions and bounds; evaluate()."""
    import torch
    from falcon_ttdforgnns_torch.train import SageTrainer
    S = STEPS_FULL_NEIGHBOR
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = SageTrainer(cut(ds, S), config(use_sample=False), device=dev)
    tr._full_graph()  # the edge list on the card before the counted steps
    log(f"--full-neighbor: SAGE {tr.cfg.num_layers}x{tr.cfg.hidden_dim}, f32, batch "
        f"{tr.cfg.batch_size}, {S} steps over {ds.graph.num_edges} edges each")
    counts["full-neighbor"] = counted_epoch(tr, 0, "full-neighbor", ("tt_fwd", "tt_grads"), S)
    if (counts["full-neighbor"]["tt_fwd"], counts["full-neighbor"]["tt_grads"]) != (S, S):
        raise AssertionError(f"full-neighbor launches {counts['full-neighbor']}: one tt_fwd "
                             f"and one tt_grads a step expected")
    peak = torch.cuda.max_memory_allocated()
    seeds = torch.as_tensor(ds.train_idx[:1024].astype(np.int64), device=dev)
    ops, wall_us, _ = complete_profile(
        lambda: tr.full_neighbor_step(seeds),
        lambda ops: sorted(c for k, (c, _) in ops.items()
                           if "tt_fwd_kernel" in k or "tt_grads_kernel" in k) == [1, 1],
        "a full-neighbor step")
    dev_ms = {}
    for name in ("tt_fwd_kernel", "tt_grads_kernel"):
        dev_ms[name] = (None if ops is None else
                        sum(us for k, (_, us) in ops.items() if name in k) / 1e3)
    shapes, n = tr.shapes, ds.num_nodes
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    cores = [c.detach() for c in tr.cores]
    walk, fwd_walk = walk_counts(K, shapes, ids)
    fb, fby = fwd_bound(shapes, fwd_walk, 4)
    gb, gby = grads_bound(shapes, walk, 4)
    d_out = torch.randn((n, shapes.embedding_dim), device=dev)
    fwd_ms = cuda_ms(lambda: K.tt_fwd(shapes, cores, ids), 5)
    grads_ms = cuda_ms(lambda: K.tt_grads(shapes, cores, ids, d_out), 5)
    fwd_plain = cuda_ms(lambda: K.tt_fwd_plain(shapes, cores, ids), 1)
    grads_plain = cuda_ms(lambda: K.tt_grads_plain(shapes, cores, ids, d_out), 1)
    del d_out

    def ms4(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    log(f"  {walk_line('the full-neighbor lookup', shapes, walk, fwd_walk)}")
    log(f"  tt_fwd over all {n} ids (f32 store): {fwd_ms:.4f} ms a call with the sort "
        f"(device, in the profiled step: {ms4(dev_ms['tt_fwd_kernel'])}), plain "
        f"{fwd_plain:.2f} ms, bound {fb:.4f} ms by {fby}")
    log(f"  tt_grads over all {n} ids (f32 d_out): {grads_ms:.4f} ms a call with the sort "
        f"(device: {ms4(dev_ms['tt_grads_kernel'])}), plain {grads_plain:.2f} ms, bound "
        f"{gb:.4f} ms by {gby}")
    busy = None if ops is None else sum(us for _, us in ops.values()) / 1e3
    log(f"  the profiled step: {ms4(None if ops is None else wall_us / 1e3)} (profiler on), "
        f"device busy {ms4(busy)}; peak device memory over the {S} steps "
        f"{peak / 2**30:.2f} GiB")
    checked_evaluate(tr, "full-neighbor evaluate")
    del tr, cores, ids
    torch.cuda.empty_cache()


def node_shard_phase(ds, config, dev, counts) -> None:
    """--full-neighbor --node-shard (ROADMAP A8.3) on the card over a
    one-rank NCCL group (a file store in a temporary directory) given to
    the trainer, so that it takes the node-sharded step (see the module's
    docstring), against --full-neighbor from the same state; then the
    sharded inference against infer_full, the ring's index_add_ (CUDA
    events) and logical_shards_check.  Fills counts["node-shard"]."""
    import tempfile
    import torch
    import torch.distributed as dist
    from falcon_ttdforgnns_torch.parallel import (destroy_process_group, init_process_group,
                                                  ring_spmm)
    from falcon_ttdforgnns_torch.train import SageTrainer
    S = STEPS_NODE_SHARD
    cfg = config(use_sample=False, node_shard=True, dropout=0.0)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group("cuda", f"file://{tmp}/store", 0, 1,
                           local_rank=torch.cuda.current_device())
        try:
            ns = SageTrainer(cut(ds, S), cfg, device=dev, group=dist.group.WORLD)
            one = SageTrainer(cut(ds, S), cfg, device=dev)  # no group: the single-device path
            mesh, lay = ns.node_mesh, ns.nshard.layout
            rows = ns.nshard.node_ids.numel()
            log(f"  a node mesh of {mesh.n_data} x {mesh.n_node} over {dist.get_backend()}; the "
                f"ragged layout: {ns.nshard_layout_s:.1f} s on the host, chunk {lay.chunk}, "
                f"max_chunks {lay.max_chunks}, memory ratio {lay.memory_ratio:.4f}, a block of "
                f"{rows} rows; without the group: {one.node_mesh}")
            if (mesh.n_data, mesh.n_node) != (1, 1) or one.node_mesh is not None or \
                    rows != ds.num_nodes:
                raise AssertionError("node-shard: a 1 x 1 mesh over all rows given the group, "
                                     "the single-device path without it")
            two = SageTrainer(cut(ds, S), cfg, device=dev)
            for tr in (one, two):
                tr.model.load_state_dict(ns.model.state_dict())
                tr._full_graph()  # the edge list on the card before the timed steps
            # the identity: the first batch's loss and gradients, no update
            pick = np.random.default_rng(cfg.seed).permutation(ns.ds.train_idx)[:cfg.batch_size]
            loss_ns, _, grads_ns = ns.node_sharded_grads(pick)
            labels = one._eval_labels()[0]
            seeds = torch.as_tensor(pick.astype(np.int64), device=dev)
            logits = one.model.forward_full_graph(one._full_graph())
            loss_one = torch.nn.functional.cross_entropy(logits.index_select(0, seeds),
                                                         labels.index_select(0, seeds))
            grads_one = torch.autograd.grad(loss_one, one._trained())
            loss_one = loss_one.detach()
            names = {id(p): n for n, p in one.model.named_parameters()}
            rel, worst = max((float((a - b).norm() / b.norm()), names[id(p)])
                             for a, b, p in zip(grads_ns, grads_one, one._trained()))
            log(f"  the first batch, no update: loss {float(loss_ns):.7f} node-sharded against "
                f"{float(loss_one):.7f}; every gradient within {rel:.2e} of its norm (the "
                f"farthest {worst})")
            del logits, grads_ns, grads_one
            # the weight gradients are f32 sums over 2.45M rows, in another
            # order on each path: ~eps sqrt(N) = 9e-5 relative
            if rel > 1e-3 or not math.isclose(float(loss_ns), float(loss_one), rel_tol=1e-5):
                raise AssertionError("node-shard: the first batch's loss or gradients differ "
                                     "from the full-neighbor step's")
            run = {}
            for tr, label in ((ns, "node-sharded"), (one, "full-neighbor"),
                              (two, "full-neighbor again")):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                stats = tr.train_epoch(0)
                got = checked_counts(label, ("tt_fwd", "tt_grads"), S)
                if (got.get("tt_fwd"), got.get("tt_grads"), tr.step) != (S, S, S):
                    raise AssertionError(f"{label}: {tr.step} steps, launches {got}: one "
                                         f"tt_fwd and one tt_grads a step expected")
                run[label] = (stats, torch.cuda.max_memory_allocated(), got)
            counts["node-shard"] = run["node-sharded"][2]
            (sn, pn, _), (sf, pf, _) = run["node-sharded"], run["full-neighbor"]
            log(f"  {S} steps each from the same state, dropout 0: node-sharded "
                f"{sn['epoch_time'] * 1e3 / S:.1f} ms a step, peak {pn / 2**30:.2f} GiB, loss "
                f"{sn['loss']:.6f}; --full-neighbor {sf['epoch_time'] * 1e3 / S:.1f} ms a step, "
                f"peak {pf / 2**30:.2f} GiB, loss {sf['loss']:.6f}; again "
                f"{run['full-neighbor again'][0]['epoch_time'] * 1e3 / S:.1f} ms a step")
            hold_loss(dict(node_shard="epoch 0"), S, sn["loss"], sf["loss"], False)
            for other, what in ((ns, "node-sharded"), (two, "a second full-neighbor run")):
                offs = [(a.detach() - b.detach()).abs()
                        for a, b in zip(other.model.parameters(), one.model.parameters())]
                log(f"  {what} against the first full-neighbor run after {S} Adam steps: "
                    f"shares of elements more than 3e-3 lr / 0.1 lr apart "
                    f"{sum(int((o > 3e-3 * LR).sum()) for o in offs) / sum(o.numel() for o in offs):.4f}"
                    f" / {sum(int((o > 0.1 * LR).sum()) for o in offs) / sum(o.numel() for o in offs):.4f},"
                    f" max {max(float(o.max()) for o in offs):.3e}")
            # Adam's first steps carry a near-cancelled gradient element's
            # reordering error whole (about lr * sign(g)): the card-vs-card
            # margin of dist_phase and the checkpoint phases
            hold_params(dict(node_shard="one NCCL rank"), ns, one, True, steps=S,
                        where="products")
            del two
            # inference and evaluate of one state, each route's second call timed
            one.model.load_state_dict(ns.model.state_dict())
            ms = {}
            for tr in (ns, one):
                logits = tr.infer_full()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = tr.infer_full()
                torch.cuda.synchronize()
                infer_ms = (time.perf_counter() - t0) * 1e3
                tr.evaluate()
                t0 = time.perf_counter()
                accs = tr.evaluate()
                ms[tr] = (logits, infer_ms, (time.perf_counter() - t0) * 1e3, accs)
            (sharded, si, se, sa), (full, fi, fe, fa) = ms[ns], ms[one]
            err = float((sharded - full).abs().max())
            flips = int((sharded.argmax(-1) != full.argmax(-1)).sum())
            log(f"  infer_full_sharded against infer_full: max abs diff {err:.3e} (logits up to "
                f"{float(full.abs().max()):.3e}), {flips} argmax flips of {full.shape[0]}; "
                f"{si:.0f} against {fi:.0f} ms; evaluate() {se:.0f} (sharded) against {fe:.0f} "
                f"ms (xla), {sa} against {fa}")
            torch.testing.assert_close(sharded, full, rtol=1e-4, atol=1e-4)
            if any(abs(sa[k] - fa[k]) > SPMM_ROUTE_ACC for k in fa):
                raise AssertionError(f"node-shard evaluate {sa} against xla {fa}")
            del sharded, full, logits, ms
            h = torch.randn((rows, 256), device=dev)
            pieces = ns.nshard.shard.buckets[0]

            def gathers():
                for src_piece, _, _ in pieces:
                    h.index_select(0, src_piece)

            ring_ms = cuda_ms(lambda: ring_spmm(h, ns.nshard.shard, mesh), 3)
            gather_ms = cuda_ms(gathers, 3)
            log(f"  the ring at D = 256 over all edges (one block, no rotation, {len(pieces)} "
                f"pieces), CUDA events: {ring_ms:.1f} ms a call, of which the pieces' "
                f"index_select {gather_ms:.1f} ms and their index_add_ the rest, "
                f"{ring_ms - gather_ms:.1f} ms")
            del h
        finally:
            destroy_process_group()
    del ns, one
    torch.cuda.empty_cache()
    logical_shards_check(ds, dev)


def logical_shards_check(ds, dev) -> None:
    """The ragged layout of the products graph at LOGICAL_SHARDS shards,
    consumed in one process: for each shard and rotation, the block that
    rotation delivers handed to the ring's consume (and the shard's rows
    to consume_transposed, into the delivered block's rows), in the ring's
    edge_chunk pieces, on 64 integer-valued columns, so that every sum is
    exact in f32: the shards' rows must equal the plain full-graph sum
    (and its transpose) bit for bit.  The only way one card runs a
    4-shard layout's slices."""
    import torch
    from falcon_ttdforgnns_torch.ops.segment import spmm_sum_chunked
    from falcon_ttdforgnns_torch.parallel import (consume, consume_transposed,
                                                  partition_edges_ragged, ragged_shard)
    S, n = LOGICAL_SHARDS, ds.num_nodes
    src, dst = ds.graph.to_coo()
    t0 = time.perf_counter()
    lay = partition_edges_ragged(src.astype(np.int64), dst.astype(np.int64), n, S)
    host_s = time.perf_counter() - t0
    top = int(max(ds.graph.degrees.max(), np.bincount(src, minlength=n).max()))
    if 8 * top >= 2 ** 24:
        raise AssertionError(f"a degree of {top}: integer sums past f32's exact range")
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randint(-8, 9, (lay.num_rows_padded, 64), generator=gen, device=dev).float()
    out, back = torch.zeros_like(h), torch.zeros_like(h)
    blocks, b = h.split(lay.block), lay.block
    t0 = time.perf_counter()
    for d in range(S):
        shard = ragged_shard(lay, d, dev)
        for i in range(S):
            k = (d + i) % S
            consume(out[d * b:(d + 1) * b], blocks[k], shard.buckets[i])
            consume_transposed(back[k * b:(k + 1) * b], blocks[d], shard.buckets[i])
        del shard
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    row_of = torch.as_tensor(lay.row_of, device=dev)
    nodes = h.index_select(0, row_of)
    s, t = (torch.as_tensor(a.astype(np.int64), device=dev) for a in (src, dst))
    same = (torch.equal(out.index_select(0, row_of), spmm_sum_chunked(nodes, s, t, n)),
            torch.equal(back.index_select(0, row_of), spmm_sum_chunked(nodes, t, s, n)))
    log(f"  {S} logical shards of products in one process: the layout {host_s:.1f} s on the "
        f"host (chunk {lay.chunk}, max_chunks {lay.max_chunks}, memory ratio "
        f"{lay.memory_ratio:.4f}, per-shard real edges {lay.nreal.sum(axis=1).tolist()}); "
        f"the {S * S} consumes and their transposes {dev_s:.2f} s; equal to the plain sum and "
        f"its transpose bit for bit: {same}")
    if not all(same):
        raise AssertionError(f"the {S}-shard consume is off the plain sum: {same}")
    del h, out, back, nodes, s, t
    torch.cuda.empty_cache()


CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints", "chip_smoke")


def same_state(a, b, where: str = "") -> None:
    """Raise unless two nested checkpoint states are equal: tensors bit for
    bit (wherever they lie), containers key for key, other values by ==."""
    import torch
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu())):
            raise AssertionError(f"restored state differs at {where}")
    elif isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"restored state differs at {where}: keys")
        for k in a:
            same_state(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"restored state differs at {where}: length")
        for i, (x, y) in enumerate(zip(a, b)):
            same_state(x, y, f"{where}[{i}]")
    elif a != b:
        raise AssertionError(f"restored state differs at {where}: {a!r} against {b!r}")


def checkpoint_roundtrip(saved, fresh, label: str) -> None:
    """saved.save(), fresh.restore() of that file: the save's and the
    restore's seconds and the file's MB; every tensor of the state (model,
    optimizers, plateau, generators, loader) restored bit for bit."""
    import shutil
    import torch
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = saved.save(CKPT_DIR)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_state(saved.checkpoint_state(), fresh.checkpoint_state(), label)
    if fresh.step != saved.step:
        raise AssertionError(f"{label}: step {fresh.step} restored, {saved.step} saved")
    log(f"  {label} checkpoint: {os.path.getsize(path) / 1e6:.1f} MB, save {save_s:.2f} s, "
        f"restore {restore_s:.2f} s; every tensor of the state restored bit for bit")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)


def checkpoint_phase(ds, config, dev) -> None:
    """The puregpu flagship (--bf16 --sparse, fused Adam): an epoch of
    CKPT_STEPS steps, save, a fresh trainer restored (checkpoint_roundtrip),
    then both take the same next epoch and agree within hold_params'
    card-vs-card margin (tt_grads adds with atomics, so bits may differ)."""
    import torch
    from falcon_ttdforgnns_torch.train import SageTrainer
    S = CKPT_STEPS
    cfg = config(mode="puregpu", sparse=True, bf16=True, steps_per_call=S)
    first = SageTrainer(cut(ds, S), cfg, device=dev)
    first.train_epoch(0)
    restored = SageTrainer(cut(ds, S), cfg, device=dev)
    checkpoint_roundtrip(first, restored, "flagship")
    losses = [t.train_epoch(1)["loss"] for t in (first, restored)]
    hold_loss(dict(flagship="restored"), 1, losses[1], losses[0], True)
    hold_params(dict(flagship="restored", epoch=1), restored, first, True, steps=S,
                where="products")
    del first, restored
    torch.cuda.empty_cache()


# ------------------------------------- the single-card tools, the other models
RANK_GRID = [(2, 2), (23, 23), (7, 131), (256, 2), (2, 256), (256, 256)]  # the tuner's box
TUNE_BUDGET = 3      # the autotuning preset's --tune-budget, cut from its 20
RGAT_STEPS = 3       # full-graph Adam steps of RGAT at MAG240M's widths
MOL_STEPS = 3        # timed Adam steps of MolGNN at each batch size
PRODUCTS_PQ = ((125, 140, 140), (5, 5, 4))


def bf16_within(name: str, got, want, tol: float = 1e-5) -> float:
    """A bf16 store at a high rank against its plain version: each value
    within one bf16 step of the plain value plus tol of the largest, what
    two f32 rows within tol of their largest (TOL["tt_fwd"]) can round to
    (an output that cancels far below the largest may round more than one
    step apart).  Returns the largest absolute error."""
    import torch
    g, w = got.float(), want.float()
    step = torch.where(w == 0, torch.zeros_like(w),
                       torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8))
    diff = (g - w).abs()
    bad = int((diff > step + tol * float(w.abs().max())).sum())
    equal = float((got.view(torch.int16) == want.view(torch.int16)).float().mean())
    log(f"  {name}: {equal:.6f} of bf16 values bit-identical, {bad} past one step and "
        f"{tol:.0e} of the largest {'ok' if bad == 0 else 'FAILED'}")
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version")
    return float(diff.max())


def rank_phase(dev, n_ids: int = 4096) -> None:
    """C3: tt_fwd (f32, bf16), tt_fwd_sr and tt_grads (f32 and bf16 d_out)
    against their plain versions at every rank pair of RANK_GRID at the
    products p/q on n_ids ids (a hot id across chunks), with the launch
    configuration each takes; then tt_fwd and tt_grads at 256, 256 on
    937,984 zipf ids (the main path's count): ms, launches, bounds."""
    import torch
    from falcon_ttdforgnns_torch.ops import tt_init
    from falcon_ttdforgnns_torch.ops import tt_kernels as K
    from falcon_ttdforgnns_torch.ops.tt_shapes import make_tt_shapes
    seed = torch.tensor(4242, dtype=torch.int32, device=dev)
    for ranks in RANK_GRID:
        shapes = make_tt_shapes(2_449_029, 100, ranks, *PRODUCTS_PQ)
        cores = [torch.tensor(c, device=dev) for c in tt_init.init_tt_cores(shapes, "normal", 0)]
        rng = np.random.default_rng(sum(ranks))
        ids = rng.integers(0, shapes.num_embeddings, n_ids).astype(np.int32)
        ids[::7] = ids[0]
        ids = torch.tensor(ids, device=dev)
        g = torch.randn(n_ids, 100, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        reset_counts()
        label = f"ranks {ranks}"
        check(f"tt_fwd {label}", [("out", K.tt_fwd(shapes, cores, ids),
                                   K.tt_fwd_plain(shapes, cores, ids), "tt_fwd")])
        bf16_within(f"tt_fwd[bf16] {label}", K.tt_fwd(shapes, cores, ids, torch.bfloat16),
                    K.tt_fwd_plain(shapes, cores, ids, torch.bfloat16))
        bf16_within(f"tt_fwd_sr {label}", K.tt_fwd_sr(shapes, cores, ids, seed),
                    K.tt_fwd_sr_plain(shapes, cores, ids, seed))
        for d_out in (g, g.to(torch.bfloat16)):
            check(f"tt_grads {label} ({str(d_out.dtype)[6:]} d_out)",
                  [(f"core {k}", a, b, "tt_grads") for k, (a, b) in enumerate(zip(
                      K.tt_grads(shapes, cores, ids, d_out),
                      K.tt_grads_plain(shapes, cores, ids, d_out)))])
        counts = launched()
        if any(counts.get(k) != 1 for k in ("tt_fwd", "tt_fwd[bf16]", "tt_fwd_sr", "tt_grads",
                                            "tt_grads[bf16]")):
            raise AssertionError(f"{label}: launches {counts}")
        fr = shapes.full_ranks
        fwd_warp = 4 * (((100 + 3) & ~3) + ((5 * fr[1] + 25 * fr[2] + 3) & ~3)
                        + ((25 * fr[2] + 3) & ~3)) + 8 * 32
        grads_warp = 4 * (2 * (5 * fr[1] + 25 * fr[2]) + 100) + 8 * 32
        warps = [next(w for w in (8, 4, 2, 1) if w * b <= 232448) for b in (fwd_warp, grads_warp)]
        log(f"  {label}: shared memory a warp {fwd_warp} B (tt_fwd), {grads_warp} B "
            f"(tt_grads): {warps[0]} and {warps[1]} warps a CTA")
        del cores
    # 256, 256 at the main path's size
    shapes = make_tt_shapes(2_449_029, 100, (256, 256), *PRODUCTS_PQ)
    cores = [torch.tensor(c, device=dev) for c in tt_init.init_tt_cores(shapes, "normal", 0)]
    rng = np.random.default_rng(0)
    perm = rng.permutation(shapes.num_embeddings)
    ids = torch.tensor(perm[(rng.zipf(ZIPF_A, IDS_PER_STEP) - 1) % shapes.num_embeddings]
                       .astype(np.int32), device=dev)
    d_out = torch.randn((IDS_PER_STEP, 100), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    walk, fwd_walk = walk_counts(K, shapes, ids)
    fb, fby = fwd_bound(shapes, fwd_walk, 4)
    gb, gby = grads_bound(shapes, walk, 4)
    order = K.grouped_order(ids)
    reset_counts()
    fwd_ms = cuda_ms(lambda: K.tt_fwd(shapes, cores, ids), 5)
    fwd_o_ms = cuda_ms(lambda: K.tt_fwd(shapes, cores, ids, order=order), 5)
    grads_ms = cuda_ms(lambda: K.tt_grads(shapes, cores, ids, d_out, order=order), 5)
    counts = launched()
    log(f"  ranks (256, 256) on {IDS_PER_STEP} zipf ids ({walk['distinct']} distinct, "
        f"{walk['prefix_runs']} prefix runs): tt_fwd {fwd_ms:.4f} ms ({fwd_o_ms:.4f} with the "
        f"sort given), bound {fb:.4f} ms by {fby}; tt_grads (f32 d_out, the sort given) "
        f"{grads_ms:.4f} ms, bound {gb:.4f} ms by {gby}; launches {counts}; the plain "
        f"versions not measured at this size (their gathered core rows would take 1.2 TB)")


def segment_kernel_check(ds, dev) -> dict:
    """C2: segment_mean_bf16 (the port's own kernel: the reference's bf16
    full-graph mean) against its plain version bit for bit on a slice of
    the products graph's rows around its highest in-degree row, plus 64
    rows without in-edges, at D = 100 and 256, values N(0, 1) and
    N(0, 3e4^2); then timed over the whole graph (evaluate's shape) at
    D = 256 and 100, beside its plain version and, as another function,
    the chunked index_add_ that evaluate ran before (f32 accumulation).
    Then the same for csr_mean_f32, the f32 mean of a bf16 evaluate's
    first layer (:func:`csr_mean_check`), and for csr_mean_bf16, the mean of
    its last conv's product (:func:`csr_mean_bf16_check`).  Returns its JSON
    results (segment_mean_bf16 at D = 256, csr_mean_f32 at D = 100,
    csr_mean_bf16 at D = 48)."""
    import torch
    from falcon_ttdforgnns_torch.ops import segment
    g, n = ds.graph, ds.num_nodes
    index, dst, s_index, (lo, hi, top) = row_indexes(g, dev)
    deg_np = np.diff(g.indptr)
    deg = torch.tensor(deg_np.astype(np.float32), device=dev)
    s_deg = torch.cat([deg[lo:hi], torch.zeros(64, device=dev)])
    gen = torch.Generator(device=dev).manual_seed(5)
    for d in (100, 256):
        for scale in (1.0, 3e4):
            h = (torch.randn(n, d, generator=gen, device=dev) * scale).to(torch.bfloat16)
            got = segment.segment_mean_bf16(h, s_index, s_deg)
            want = segment.segment_mean_bf16_plain(h, s_index.src, s_index.indptr, s_deg)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"segment_mean_bf16 at D={d}, scale {scale}: not "
                                     f"bit-identical to its plain version")
    log(f"  segment_mean_bf16 bit-identical to its plain version on rows {lo}..{hi - 1} "
        f"(in-degree up to {int(deg_np[top])} at row {top}) and 64 rows without in-edges, "
        f"D = 100 and 256, values N(0, 1) and N(0, 3e4^2)")
    src, res = index.src, {}
    for d in (100, 256):
        h = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        reset_counts()
        ms = cuda_ms(lambda: segment.segment_mean_bf16(h, index, deg), 5)
        launches = launched().get("segment_mean_bf16", 0)
        t0 = time.perf_counter()
        plain = segment.segment_mean_bf16_plain(h, src, index.indptr, deg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = segment.segment_mean_bf16(h, index, deg)
        if not torch.equal(got.view(torch.int16), plain.view(torch.int16)):
            raise AssertionError(f"segment_mean_bf16 over the whole graph at D={d}: not "
                                 f"bit-identical to its plain version")
        del plain, got
        add_ms = cuda_ms(lambda: segment.spmm_sum_chunked(h, src, dst, n), 3)
        E = src.numel()
        bound, by = bound_ms(2 * 2 * n * d + 8 * E + 8 * (n + 1) + 4 * n, E * d + n * d)
        log(f"  segment_mean_bf16 over all {n} rows and {E} edges, D = {d}: {ms:.3f} ms "
            f"({launches} launches in the timing), plain version {plain_ms:.1f} ms (one call, "
            f"host clock), bound {bound:.4f} ms by {by}; the chunked index_add_ sum of the "
            f"same h, another function (f32 accumulation, no division) {add_ms:.3f} ms")
        if d == 256:
            res["segment_mean_bf16"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                            bound_ms=bound, bound_by=by, library_ms=None,
                                            index_add_ms=add_ms)
    res.update(csr_mean_check(g, (s_index, s_deg), (index, deg, dst), gen, dev))
    res.update(csr_mean_bf16_check(g, (s_index, s_deg), (index, deg), gen, dev))
    return res


def row_indexes(g, dev):
    """The row index of the graph's in-edges on the card, their dst, and
    the index of a slice of its rows around its highest in-degree row plus
    64 rows without in-edges, whose sources index every row; (index, dst,
    slice index, (lo, hi, top)): the slice is rows lo..hi - 1, top the
    highest in-degree row."""
    import torch
    from falcon_ttdforgnns_torch.ops import segment
    n = g.num_nodes
    indptr = torch.tensor(g.indptr.astype(np.int64), device=dev)
    src = torch.tensor(g.indices.astype(np.int64), device=dev)
    dst = torch.repeat_interleave(torch.arange(n, device=dev), indptr.diff())
    top = int(np.diff(g.indptr).argmax())
    lo, hi = max(0, top - 20000), min(n, top + 20000)
    e0, e1 = int(g.indptr[lo]), int(g.indptr[hi])
    return (segment.edges_by_row(src, dst, n), dst,
            segment.edges_by_row(src[e0:e1], dst[e0:e1] - lo, hi - lo + 64, n), (lo, hi, top))


def csr_mean_check(g, rows_slice, rows_all, gen, dev) -> dict:
    """csr_mean_f32 (the f32 full-graph mean: layer 1 of the bf16 evaluate
    at D = 100, the f32 evaluate's layers at 100 and 256) against its plain
    version on the CPU (an index_add_ that adds in edge order) bit for bit
    on segment_kernel_check's slice of rows, its h aligned and one float
    past a 16-byte boundary (the scalar path); then timed over the whole
    graph beside its plain version on the card (one call, host clock) and
    the chunked index_add_ path evaluate ran before, each with its
    division by the degree; over the whole graph the two sum in different
    orders, so they must agree to f32 reassociation (max |diff| at most
    CSR_MEAN_REL_TOL of max |plain|; a dropped or doubled edge in a row of
    in-degree k reads about 0.5 / k).  Returns its JSON results (D = 100)."""
    import torch
    from falcon_ttdforgnns_torch.ops import segment
    n = g.num_nodes
    s_index, s_deg = rows_slice
    index, deg, dst = rows_all
    src = index.src
    cpu = [t.cpu() for t in (s_index.src, s_index.indptr, s_deg)]
    for d in (100, 256):
        h = torch.randn(n, d, generator=gen, device=dev)
        buf = torch.empty(n * d + 1, device=dev)
        buf[1:] = h.reshape(-1)
        want = segment.csr_mean_f32_plain(h.cpu(), *cpu)
        for label, x in (("aligned", h), ("one float past 16 bytes", buf[1:].view(n, d))):
            got = segment.csr_mean_f32(x, s_index, s_deg).cpu()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"csr_mean_f32 at D={d}, h {label}: not bit-identical to "
                                     f"its plain version on the CPU")
        del buf, want, got
    log(f"  csr_mean_f32 bit-identical to its plain version on the CPU on the same rows, "
        f"D = 100 and 256, h aligned and one float past 16 bytes")
    degc = deg.clamp(min=1.0)[:, None]
    res = {}
    for d in (100, 256):
        h = torch.randn(n, d, generator=gen, device=dev)
        reset_counts()
        ms = cuda_ms(lambda: segment.csr_mean_f32(h, index, deg), 5)
        launches = launched().get("csr_mean_f32", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = segment.csr_mean_f32_plain(h, src, index.indptr, deg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        chunked_ms = cuda_ms(lambda: segment.spmm_sum_chunked(h, src, dst, n) / degc, 3)
        got = segment.csr_mean_f32(h, index, deg)
        abs_err = float((got - plain).abs().max())
        err = abs_err / float(plain.abs().max())
        del plain, got
        if not err <= CSR_MEAN_REL_TOL:
            raise AssertionError(f"csr_mean_f32 over the whole graph at D={d}: max |diff| "
                                 f"{err:.2e} of max |plain|, above {CSR_MEAN_REL_TOL}")
        E = src.numel()
        bound, by = bound_ms(8 * n * d + 8 * E + 8 * (n + 1) + 4 * n, E * d + n * d)
        log(f"  csr_mean_f32 over all {n} rows and {E} edges, D = {d}: {ms:.3f} ms "
            f"({launches} launches in the timing; {4 * E * d / ms / 1e6:.0f} GB/s of row "
            f"gathers), plain version {plain_ms:.1f} ms (one call, host clock; max |diff| "
            f"{abs_err:.2e}, {err:.1e} of max |plain|, limit {CSR_MEAN_REL_TOL}; its atomic "
            f"adds in no order), bound {bound:.4f} ms by {by}; the "
            f"chunked index_add_ path it replaced {chunked_ms:.3f} ms")
        if d == 100:
            res["csr_mean_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by=by, library_ms=None,
                                       index_add_ms=chunked_ms)
    return res


def csr_mean_bf16_check(g, rows_slice, rows_all, gen, dev) -> dict:
    """csr_mean_bf16 (the mean of a bf16 product summed in f32: the last
    conv's of the bf16 evaluate, 47 classes padded to D = 48) against its
    plain version on the card (its sums in edge order on any device) bit for
    bit: on segment_kernel_check's slice of rows at D = 8 and 48, values
    N(0, 1) and N(0, 3e4^2); then over the whole graph at D = 48, timed beside its plain version (one
    call, host clock) and, as the path it replaced, segment_mean_bf16 of the
    256-wide rows the layer gathered before.  Returns its JSON results
    (D = 48)."""
    import torch
    from falcon_ttdforgnns_torch.ops import segment
    n = g.num_nodes
    s_index, s_deg = rows_slice
    index, deg = rows_all
    for d in (8, 48):
        for scale in (1.0, 3e4):
            p = (torch.randn(n, d, generator=gen, device=dev) * scale).to(torch.bfloat16)
            want = segment.csr_mean_bf16_plain(p, s_index.src, s_index.indptr, s_deg)
            got = segment.csr_mean_bf16(p, s_index, s_deg)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"csr_mean_bf16 at D={d}, scale {scale}: not "
                                     f"bit-identical to its plain version")
            del want, got
    log("  csr_mean_bf16 bit-identical to its plain version on the same rows, D = 8 and 48, "
        "values N(0, 1) and N(0, 3e4^2)")
    d, src, E = 48, index.src, index.src.numel()
    p = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    reset_counts()
    ms = cuda_ms(lambda: segment.csr_mean_bf16(p, index, deg), 5)
    launches = launched().get("csr_mean_bf16", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = segment.csr_mean_bf16_plain(p, src, index.indptr, deg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = segment.csr_mean_bf16(p, index, deg)
    if not torch.equal(got.view(torch.int16), plain.view(torch.int16)):
        raise AssertionError(f"csr_mean_bf16 over the whole graph at D={d}: not "
                             f"bit-identical to its plain version")
    del plain, got, p
    h = torch.randn(n, 256, generator=gen, device=dev).to(torch.bfloat16)
    wide_ms = cuda_ms(lambda: segment.segment_mean_bf16(h, index, deg), 3)
    del h
    bound, by = bound_ms(2 * 2 * n * d + 8 * E + 8 * (n + 1) + 4 * n, E * d + n * d)
    log(f"  csr_mean_bf16 over all {n} rows and {E} edges, D = {d}: {ms:.3f} ms "
        f"({launches} launches in the timing; {2 * E * d / ms / 1e6:.0f} GB/s of row "
        f"gathers), bit-identical to its plain version, {plain_ms:.1f} ms (one call, host "
        f"clock), bound {bound:.4f} ms by {by}; the layer's mean before, segment_mean_bf16 "
        f"at D = 256, {wide_ms:.3f} ms")
    return {"csr_mean_bf16": dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, library_ms=None)}


def gat_kernel_check(ds, dev) -> dict:
    """csr_gat_bf16 and csr_gat_f32 (the sampled GAT's full-graph attention,
    ops/attention.py) against their plain version run on the CPU, on
    segment_kernel_check's slice of the products graph's rows around its
    highest in-degree row plus 64 rows without in-edges, at the GAT's two
    layer shapes (4 heads of 128 side by side; 4 heads of 48, the 47
    classes padded, averaged); then timed over the whole graph beside its
    plain version on the card (one call, host clock) and, as the library
    path, the f32 aggregation of nn/layers.py GATConv (scatter max, exp,
    scatter sum, headed_spmm) on one hidden layer.  Each row sums in its
    own order on the card: f32 agrees to 1e-5 of max |plain|, bf16 within
    one bf16 step.  Returns its JSON results."""
    import torch
    from falcon_ttdforgnns_torch.ops import attention, segment
    g, n = ds.graph, ds.num_nodes
    index, dst, s_index, (lo, hi, top) = row_indexes(g, dev)
    deg_np, src, rows = np.diff(g.indptr), index.src, s_index.num_rows
    gen = torch.Generator(device=dev).manual_seed(9)
    shapes = ((4, 128, False), (4, 48, True))
    for dtype in (torch.bfloat16, torch.float32):
        for heads, cp, mean in shapes:
            # the slice's row r takes x[r] as its self-loop: x holds every row
            x = torch.randn(n + 64, heads * cp, generator=gen, device=dev).to(dtype)
            el = torch.randn(n + 64, heads, generator=gen, device=dev) * 2
            er = torch.randn(rows, heads, generator=gen, device=dev) * 2
            want = attention.csr_gat_plain(
                *(t.cpu() for t in (x.float(), el, er, s_index.src, s_index.indptr)), heads,
                mean)
            got = attention.csr_gat(x, el, er, s_index, heads, mean).cpu().float()
            tol = 1e-5 * float(want.abs().max()) + (2.0 ** -8 * want.abs()
                                                    if dtype == torch.bfloat16 else 0.0)
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(f"csr_gat {dtype} at {heads} x {cp} (mean {mean}): max "
                                     f"|diff| {float((got - want).abs().max()):.3g}")
    log(f"  csr_gat_bf16 and csr_gat_f32 agree with their plain version on the CPU on rows "
        f"{lo}..{hi - 1} (in-degree up to {int(deg_np[top])}) and 64 rows without in-edges, "
        f"4 x 128 side by side and 4 x 48 averaged (f32 1e-5 of max |plain|, bf16 one step)")
    E, res = src.numel(), {}
    for dtype, (heads, cp, mean) in ((torch.bfloat16, shapes[0]), (torch.bfloat16, shapes[1]),
                                     (torch.float32, shapes[0])):
        name = "csr_gat_bf16" if dtype == torch.bfloat16 else "csr_gat_f32"
        x = torch.randn(n, heads * cp, generator=gen, device=dev).to(dtype)
        el = torch.randn(n, heads, generator=gen, device=dev) * 2
        er = torch.randn(n, heads, generator=gen, device=dev) * 2
        reset_counts()
        ms = cuda_ms(lambda: attention.csr_gat(x, el, er, index, heads, mean), 5)
        launches = launched().get(name, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attention.csr_gat_plain(x, el, er, src, index.indptr, heads, mean)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        d, c = heads * cp, 47 if mean else cp  # the last layer's useful columns
        useful = heads * c
        nbytes = (2 if dtype == torch.bfloat16 else 4) * n * (useful + (c if mean else useful))
        bound, by = bound_ms(nbytes + 8 * n * heads + 8 * E + 8 * (n + 1),
                             2 * (E + n) * useful)
        lib_ms = None
        if not mean and dtype == torch.bfloat16:
            feat = x.float().reshape(n, heads, cp)

            def library():  # nn/layers.py GATConv's aggregation, f32
                e = torch.nn.functional.leaky_relu(el.index_select(0, src)
                                                   + er.index_select(0, dst), 0.2)
                idx = dst[:, None].expand(-1, heads)
                emax = torch.full((n, heads), float("-inf"), device=dev).scatter_reduce(
                    0, idx, e, reduce="amax")
                ex = torch.exp(e - emax.index_select(0, dst))
                esum = torch.zeros((n, heads), device=dev).index_add(0, dst, ex)
                alpha = ex / torch.clamp(esum.index_select(0, dst), min=1e-9)
                return segment.headed_spmm(feat, alpha, src, dst, n)

            lib_ms = cuda_ms(library, 2)
            del feat
        gathered = (2 if dtype == torch.bfloat16 else 4) * E * d / 1e9
        log(f"  {name} over all {n} rows and {E} edges, {heads} x {cp}"
            f"{' averaged' if mean else ''}: {ms:.3f} ms ({launches} launches in the "
            f"timing; {gathered / ms:.2f} TB/s of gathered rows), plain version "
            f"{plain_ms:.1f} ms (one call, host clock), bound {bound:.4f} ms by {by}"
            + (f"; GATConv's f32 aggregation (scatters and headed_spmm) {lib_ms:.2f} ms"
               if lib_ms is not None else ""))
        if name not in res:
            res[name] = dict(max_abs_err=None, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=lib_ms)
        del x, el, er
        torch.cuda.empty_cache()
    return res


def adam_kernel_check(dev) -> dict:
    """adam_f32 (the dense parameters' Adam, ops/adam.py) on the dense
    cell's parameter list: the 2,449,029 x 100 --no-tt table and the SAGE 3
    x 256 tower at feat_dim 100 and 47 classes.  Three steps of adam_update
    (the kernel, one launch a step) against its plain body (adam_plain) on
    the same card tensors, p, m and v bit for bit, the plateau scale a
    device tensor; then timed (CUDA events, and the profiler's device time)
    beside the plain chain and, as the library yardstick only,
    torch.optim.Adam(fused=True).step on copies of the same tensors (the
    port never calls it).  Bound: 28 bytes a value.  Returns its JSON
    results."""
    import torch
    from falcon_ttdforgnns_torch.models.sage import SAGE
    from falcon_ttdforgnns_torch.ops import adam
    from falcon_ttdforgnns_torch.train.optim import (adam_init, adam_plain, adam_update,
                                                     bias_corrections)
    tower = SAGE(1, 100, 256, 47, 3, use_tt=False)
    shapes = [(2449029, 100)] + [tuple(p.shape) for n, p in tower.named_parameters()
                                 if not n.startswith("embed.")]
    del tower
    values = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(21)
    params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    plain = [p.clone() for p in params]
    sk, sp = adam_init(params), adam_init(plain)
    scale = torch.full((), 0.5, device=dev)
    reset_counts()
    for _ in range(3):
        grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        adam_update(params, grads, sk, LR, scale)
        sp.count += 1
        adam_plain(plain, grads, sp.m, sp.v, *bias_corrections(sp.count), LR, scale)
    launches = launched().get("adam_f32", 0)
    for k, name in enumerate(["table"] + [f"tower {j}" for j in range(len(shapes) - 1)]):
        for what, a, b in (("p", params[k], plain[k]), ("m", sk.m[k], sp.m[k]),
                           ("v", sk.v[k], sp.v[k])):
            if not torch.equal(a, b):
                raise AssertionError(f"adam_f32 on the dense cell's {name}: {what} not "
                                     f"bit-identical to adam_update's plain body on the card")
    if launches != 3:
        raise AssertionError(f"adam_f32: {launches} launches in 3 steps over {len(shapes)} "
                             f"tensors, not one a step")
    log(f"  adam_f32 bit-identical to adam_update's plain body on the card over 3 steps: p, "
        f"m and v of the {len(shapes)} tensors ({values} values), {launches} launches")
    del plain, sp
    torch.cuda.empty_cache()
    bc1, bc2 = bias_corrections(sk.count)

    def kernel():
        adam.adam_f32_apply(params, grads, sk.m, sk.v, bc1, bc2, LR, scale, 0.0, 0.9, 0.999,
                            1e-8)

    ms = cuda_ms(kernel, 20, warmup=2)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(lambda: adam_plain(params, grads, sk.m, sk.v, bc1, bc2, LR, scale),
                       3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernel()
    rise = torch.cuda.max_memory_allocated() - before
    lib = [p.clone() for p in params]
    for p, g in zip(lib, grads):
        p.grad = g
    opt = torch.optim.Adam(lib, lr=LR, fused=True)
    lib_ms = cuda_ms(opt.step, 20, warmup=2)
    lib_dev_ms = device_ms(opt.step)
    del lib, opt
    bound, by = bound_ms(28 * values, 0)
    gbs = 28 * values / 1e9

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    log(f"  adam_f32 over the dense cell's {values} values: {ms:.4f} ms ({gbs / ms:.3f} TB/s "
        f"of its {gbs:.2f} GB), device {fmt(dev_ms)}, bound {bound:.4f} ms by {by} "
        f"({100 * bound / ms:.1f}%), peak memory rise {rise} bytes; the plain chain "
        f"{plain_ms:.3f} ms; torch.optim.Adam(fused=True).step {lib_ms:.4f} ms, device "
        f"{fmt(lib_dev_ms)} (the yardstick only)")
    if rise != 0:
        raise AssertionError(f"adam_f32 allocated {rise} bytes")
    return {"adam_f32": dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=lib_ms, device_ms=dev_ms,
                             library_device_ms=lib_dev_ms)}


def gat_phase(ds, dev, counts) -> None:
    """The sampled GAT at the published widths of gnnbench's gat-tt-products
    configuration (3 layers of 4 heads x 128, the last 4 x 47 averaged,
    fan-out 10,10,10, batch 512, lr 0.001) through SageTrainer, --mode
    puregpu --bf16 --sparse, from reference/gat.py's weights: its first
    step's loss and gradients against that reference in float32 on the
    card (the step's sampled levels and dropout masks recorded); a timed
    epoch (seeds/s, peak device memory); then evaluate(), counted (fills
    counts["gat evaluate"])."""
    import torch
    from falcon_ttdforgnns_torch.models import gat_ns
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    from falcon_ttdforgnns_torch.train.optim import ADAM_B1
    from gnnbench.reference import gat as ref
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "gnnbench", "configs",
                           "gat-tt-products.json")) as f:
        conf = json.load(f)
    model, tt, seed = conf["model"], conf["tt"], 2024
    cfg = TrainConfig(batch_size=model["batch_size"], fanouts=tuple(model["fanouts"]),
                      dropout=model["dropout"], hidden_dim=model["hidden_dim"],
                      num_layers=model["num_layers"], tt_ranks=tuple(tt["ranks"]),
                      p_shapes=tuple(tt["p_shapes"]), q_shapes=tuple(tt["q_shapes"]),
                      seed=seed, **conf["trainer"])
    tr = SageTrainer(ds, cfg, device=dev)
    weights = ref.make_weights(conf, ds.num_nodes, ds.num_classes, seed, dev)
    params = dict(tr.model.named_parameters())
    with torch.no_grad():
        for k, w in weights.items():
            params[k].copy_(w)
    masks, inner = [], gat_ns.dropout

    def drop(h, p, train, generator):
        # the keep mask of the generator's own draw (nn/layers.py dropout's
        # rand < 1 - p): a kept ELU value can be exactly 0 in bf16
        state = generator.get_state()
        masks.append(torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p)
        generator.set_state(state)
        return inner(h, p, train, generator)

    B = cfg.batch_size
    seeds = torch.as_tensor(ds.train_idx[:B].astype(np.int32), device=dev)
    labels = torch.as_tensor(ds.labels[ds.train_idx[:B]].astype(np.int64), device=dev)
    layers = tr.sample_layers(seeds)
    gat_ns.dropout = drop
    try:
        loss = float(tr._step(seeds, layers, labels)[0])
    finally:
        gat_ns.dropout = inner
    by_id = {id(p): m for p, m in zip(tr.opt_params, tr.opt_state.m)}
    by_id.update({id(p): m for p, m in zip(tr.cores, tr.tt_opt.m)})
    got = {k: by_id[id(p)] / (1.0 - ADAM_B1) for k, p in params.items()}
    r = ref.train_readings(conf, weights, [{"seeds": seeds, "labels": labels, "layers": layers,
                                            "masks": masks}])
    med = float(np.median(list(r["grad_norms"].values())))
    gap = {k: abs(float(got[k].norm()) - r["grad_norms"][k]) / max(r["grad_norms"][k], med)
           for k in got}
    diff = {k: float((got[k] - g).norm()) / max(r["grad_norms"][k], med)
            for k, g in r["grads"].items()}
    loss_gap = abs(loss - r["losses"][0]) / r["losses"][0]
    log(f"  first step at published widths: loss {loss:.6f} against the reference's "
        f"{r['losses'][0]:.6f} (gap {loss_gap:.2e}); worst leaf's gradient norm gap "
        f"{max(gap.values()):.2e} ({max(gap, key=gap.get)}), difference "
        f"{max(diff.values()):.2e} ({max(diff, key=diff.get)}); masks "
        f"{[tuple(m.shape) for m in masks]}")
    if loss_gap > 1e-2 or max(diff.values()) > 0.2:
        raise AssertionError("the sampled GAT's first step parts from its reference")
    del r, got, weights, masks
    torch.cuda.empty_cache()
    tr.train_epoch(0)  # warm-up: every shape of the epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = tr.train_epoch(1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = -(-len(ds.train_idx) // (cfg.steps_per_call * B)) * cfg.steps_per_call
    log(f"  a timed epoch ({steps} steps of {B}): {secs:.2f} s, "
        f"{len(ds.train_idx) / secs:.0f} seeds/s ({steps * B / secs:.0f} sampled seeds/s), "
        f"loss {stats['loss']:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _, counts["gat evaluate"] = checked_evaluate(tr, "GAT bf16 evaluate",
                                                 must_launch=("tt_fwd", "csr_gat_bf16"))
    del tr
    torch.cuda.empty_cache()


def flagship_tools_phase(trainer, ds, full_accs, dev, counts) -> None:
    """On the trained flagship: --eval-sampled (its accuracies beside the
    full evaluate()'s, seconds, launches), then --store-emb (the table
    materialised through tt_fwd in chunks of 65,536 into a temporary
    directory: MB, seconds, 4,096 sampled rows against
    materialize_features), then removed."""
    import shutil
    import tempfile
    import torch
    from falcon_ttdforgnns_torch.cli import store_embedding
    reset_counts()
    t0 = time.perf_counter()
    accs = trainer.evaluate_sampled()
    sec = time.perf_counter() - t0
    counts["eval sampled"] = launched()
    log(f"  --eval-sampled: {accs} in {sec:.1f} s (full evaluate(): {full_accs}); launches "
        f"{counts['eval sampled']}")
    missing = [k for k in ("tt_fwd", "fanout_mean_bf16") if not counts["eval sampled"].get(k)]
    if missing or not all(0.0 <= a <= 1.0 for a in accs.values()):
        raise AssertionError(f"--eval-sampled gave {accs}, {missing} never launched")
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "emb_approx-normal_tt16_part0.npy")
        t0 = time.perf_counter()
        emb = store_embedding(trainer, ds.num_nodes, path)
        sec = time.perf_counter() - t0
        ids = np.random.default_rng(9).integers(0, ds.num_nodes, 4096)
        rows = np.load(path, mmap_mode="r")[ids]
        with torch.no_grad():
            want = trainer.model.materialize_features(torch.tensor(
                ids, dtype=torch.int32, device=dev)).float().cpu().numpy()
        same = np.array_equal(rows, want) and emb.shape == (ds.num_nodes, 100)
        log(f"  --store-emb: {emb.shape} f32, {os.path.getsize(path) / 1e6:.1f} MB in "
            f"{sec:.1f} s; 4,096 sampled rows {'equal' if same else 'NOT equal'} to "
            f"materialize_features'")
        if not same:
            raise AssertionError("--store-emb's rows differ from materialize_features'")
    finally:
        shutil.rmtree(tmp)


def start_cli_flags(here: str, extra=()) -> tuple:
    """python -m falcon_ttdforgnns_torch.cli with every flag this slice
    ported, in a process of its own (its torch.profiler sessions are that
    process's): --autotune --tune-budget 2 of one epoch each on
    hard-ogbn-arxiv at a tenth of its nodes (the arxiv preset's TT shapes;
    a short run, so that it is done before the timed phases, which it would
    share the card with), each candidate --profile'd, evaluated by
    --eval-sampled, its table stored by --store-emb and its access CDF drawn
    by --plot (--access-counts).  Writes into a temporary directory;
    finish_cli_flags reads and removes it.  `extra` flags go last (a
    rehearsal on the CPU)."""
    import tempfile
    tmp = tempfile.mkdtemp()
    argv = [sys.executable, "-m", "falcon_ttdforgnns_torch.cli", "--dataset", "hard-ogbn-arxiv",
            "--synthetic-scale", "0.1", "--epochs", "1", "--autotune", "--tune-budget", "2", "--eval-sampled", "--store-emb",
            "--plot", "--access-counts", "--profile", "--profile-dir", f"{tmp}/prof",
            "--ckpt-dir", f"{tmp}/ck", "--log-dir", f"{tmp}/logs", "--log-every", "1000",
            *extra]
    proc = subprocess.Popen(argv, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    CHILDREN.append(proc)
    return proc, tmp, time.perf_counter()


def finish_cli_flags(job) -> None:
    """Wait for start_cli_flags' process; raise unless it ended 0 with its
    JSON line, wrote its tables, and a trace names tt_fwd's and tt_grads'
    kernels."""
    import glob
    import shutil
    proc, tmp, t0 = job
    try:
        out, err = proc.communicate(timeout=900)
        sec = time.perf_counter() - t0
        for line in err.splitlines():
            if any(k in line for k in ("autotune:", "val_acc", "stored", "access CDF", "Error",
                                       "error")):
                log(f"  | {line[-300:]}")
        if proc.returncode != 0:
            raise AssertionError(f"the CLI's flags run failed ({proc.returncode}):\n{err[-3000:]}")
        best = json.loads(out.strip().splitlines()[-1])
        traces = sorted(glob.glob(f"{tmp}/prof/trace_*.json"))  # not the spans_*.json
        named = [all(k in open(t).read() for k in ("tt_fwd_kernel", "tt_grads_kernel"))
                 for t in traces]
        embs = glob.glob(f"{tmp}/ck/emb_*.npy")
        plot = os.path.exists(f"{tmp}/logs/access_cdf.png")
        log(f"  python -m falcon_ttdforgnns_torch.cli --autotune --tune-budget 2 --eval-sampled "
            f"--store-emb --plot --profile on hard-ogbn-arxiv at 0.1 scale: rc 0 in {sec:.0f} s, "
            f"{best}; "
            f"{len(traces)} traces ({[os.path.getsize(t) // 10**6 for t in traces]} MB), "
            f"naming tt_fwd_kernel and tt_grads_kernel: {named}; tables {len(embs)}; access "
            f"CDF {'written' if plot else 'not written (no matplotlib on this machine)'}")
        if set(best) != {"best_ranks", "objective"} or not traces or not named[0] or not embs:
            raise AssertionError("the CLI's flags run left no result, trace or table")
    finally:
        shutil.rmtree(tmp)


class _Log:
    """A logger for cli.run and its trainers that prints through log()."""

    def info(self, msg):
        log(f"  | {msg}")

    warning = error = info


def autotune_phase(ds, dev) -> None:
    """The README's autotuning preset (scripts/run_presets.sh: --model sage
    --use-tt --autotune --batch 1024 --fan-out 5,10,15, mixed mode, f32,
    routed Adam) through cli.run on the products graph already built, its
    --tune-budget cut from 20 to TUNE_BUDGET: each candidate's ranks,
    samples/s and peak device memory, then the best."""
    import contextlib
    import io
    import tempfile
    from falcon_ttdforgnns_torch import cli
    from falcon_ttdforgnns_torch.utils.config import apply_preset, parse_args
    with tempfile.TemporaryDirectory() as tmp:
        args = apply_preset(parse_args([
            "--model", "sage", "--dataset", "hard-ogbn-products", "--use-tt", "--autotune",
            "--tune-budget", str(TUNE_BUDGET), "--batch", "1024", "--fan-out", "5,10,15",
            "--log-dir", tmp, "--ckpt-dir", tmp, "--log-every", "1000", "--device", dev.type]))
        log(f"  the autotuning preset at products, --tune-budget {TUNE_BUDGET} (cut from the "
            f"preset's 20)")
        out = io.StringIO()  # the CLI prints its result as a JSON line of its own
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.run(args, ds, _Log())
        *lines, result = out.getvalue().strip().splitlines()
    for line in lines:
        log(line)
    log(f"  best {json.loads(result)} after {TUNE_BUDGET} candidates in "
        f"{time.perf_counter() - t0:.0f} s")


def rgat_phase(dev) -> None:
    """RGAT at the widths of OGB-LSC MAG240M's R-GAT baseline (hidden 1024 =
    4 heads x 256, 2 layers, dropout 0.5, 5 edge types) on the full-size
    hard-ogbn-arxiv graph, its edges split into 5 types by a seeded draw,
    features N(0, 1) at 128 columns, its 40 classes: RGAT_STEPS full-graph
    Adam steps (the port's optax-semantics Adam, lr 1e-3): finite losses,
    ms a step, peak device memory."""
    import torch
    import torch.nn.functional as F
    from falcon_ttdforgnns_torch.graph import get_dataset
    from falcon_ttdforgnns_torch.models.rgat import RGAT
    from falcon_ttdforgnns_torch.train.optim import adam_init, adam_update
    ds = get_dataset("hard-ogbn-arxiv", seed=0)
    n = ds.num_nodes
    rng = np.random.default_rng(0)
    src, dst = ds.graph.to_coo()
    etype = rng.integers(0, 5, len(src))
    typed = [(torch.tensor(src[etype == t].astype(np.int64), device=dev),
              torch.tensor(dst[etype == t].astype(np.int64), device=dev)) for t in range(5)]
    feat = torch.tensor(rng.standard_normal((n, 128), dtype=np.float32), device=dev)
    labels = torch.tensor(ds.labels.astype(np.int64), device=dev)
    train = torch.tensor(ds.train_idx, device=dev)
    model = RGAT(128, 256, ds.num_classes, 5, num_layers=2, num_heads=4, dropout=0.5,
                 generator=torch.Generator().manual_seed(0)).to(dev)
    params = list(model.parameters())
    opt, one = adam_init(params), torch.ones((), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for step in range(RGAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(feat, typed, n, train=True, generator=gen)
        loss = F.cross_entropy(logits.index_select(0, train), labels.index_select(0, train))
        adam_update(params, torch.autograd.grad(loss, params), opt, 1e-3, one)
        loss = float(loss.detach())
        times.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(loss):
            raise AssertionError(f"RGAT step {step}: loss {loss}")
        log(f"  RGAT step {step}: {times[-1]:.1f} ms, loss {loss:.4f}")
    log(f"  RGAT 2 x (4 heads x 256), 5 edge types over {n} nodes and {len(src)} edges, "
        f"{ds.num_classes} classes: {sum(p.numel() for p in params)} parameters, "
        f"{min(times[1:]):.1f} ms a step after the first, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def small_rgat_check(dev) -> None:
    """RGAT on a tiny typed graph, 3 Adam steps on the card against the same
    steps on the CPU, dropout 0: GAT's card-against-CPU margins
    (small_full_graph_check): losses within 1e-4, parameters within 3e-3
    lr but for FULL_GRAPH_OUTLIERS of them, none past 6 lr."""
    import copy
    import torch
    import torch.nn.functional as F
    from falcon_ttdforgnns_torch.models.rgat import RGAT
    from falcon_ttdforgnns_torch.train.optim import adam_init, adam_update
    rng = np.random.default_rng(3)
    n, lr = 400, 3e-3
    edges = [(rng.integers(0, n, 1500), rng.integers(0, n, 1500)) for _ in range(3)]
    feat, labels = rng.standard_normal((n, 16), dtype=np.float32), rng.integers(0, 5, n)
    cpu = RGAT(16, 8, 5, 3, num_layers=2, num_heads=2, dropout=0.0,
               generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(dev)
    for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
        typed = [(torch.tensor(s, device=d), torch.tensor(t, device=d)) for s, t in edges]
        x, y = torch.tensor(feat, device=d), torch.tensor(labels, device=d)
        params = list(model.parameters())
        opt = adam_init(params)
        model.losses = []
        for _ in range(3):
            loss = F.cross_entropy(model(x, typed, n, train=True), y)
            adam_update(params, torch.autograd.grad(loss, params), opt, lr,
                        torch.ones((), device=d))
            model.losses.append(float(loss.detach()))
    if not all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(gpu.losses, cpu.losses)):
        raise AssertionError(f"RGAT losses on the card {gpu.losses} vs the CPU {cpu.losses}")
    offs = [(a.detach().cpu() - b.detach()).abs()
            for a, b in zip(gpu.parameters(), cpu.parameters())]
    err, tol = max(float(o.max()) for o in offs), 3 * 1e-3 * lr
    share = sum(int((o > tol).sum()) for o in offs) / sum(o.numel() for o in offs)
    ok = share <= FULL_GRAPH_OUTLIERS and err <= 3 * 2 * lr
    log(f"  tiny typed graph RGAT: 3 steps, losses card vs CPU ok, max param diff {err:.3e}, "
        f"share beyond {tol:.1e} {share:.2e} (tol {FULL_GRAPH_OUTLIERS:.0e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("RGAT params on the card and on the CPU disagree")


ATOM_CARDS = (119, 4, 12, 12, 10, 6, 6, 2, 2)  # OGB's nine atom features
BOND_CARDS = (5, 6, 2)                           # and its three bond features


def mol_batch(rng, graphs: int) -> dict:
    """`graphs` synthetic molecule-shaped graphs: ~25 atoms (N(25.5, 6)
    clipped to 8..60), a chain with branches (each atom bonded to the one
    before it, or 30% of the time to an earlier one) closed by 3 rings, so
    ~27.5 bonds (ogbg-molhiv's averages: 25.5 atoms, 27.5 bonds), both
    edge directions; integer atom features within OGB's 9 cardinalities
    (fed to the atom Dense as values, as the reference stack does) and
    bond features within (5, 6, 2)."""
    src, dst, gid, off = [], [], [], 0
    for g in range(graphs):
        k = int(np.clip(round(rng.normal(25.5, 6)), 8, 60))
        par = np.where(rng.random(k - 1) < 0.7, np.arange(k - 1),
                       (rng.random(k - 1) * np.arange(1, k)).astype(np.int64))
        a = np.concatenate([np.arange(1, k), np.arange(5, 5 + 3 * 6, 6)[:3] % k])
        b = np.concatenate([par, (np.arange(5, 5 + 3 * 6, 6)[:3] - 5) % k])
        src += [a + off, b + off]
        dst += [b + off, a + off]
        gid.append(np.full(k, g))
        off += k
    src, dst = np.concatenate(src), np.concatenate(dst)
    bonds = np.stack([rng.integers(0, c, len(src) // 2) for c in BOND_CARDS], 1)
    x = np.stack([rng.integers(0, c, off) for c in ATOM_CARDS], 1).astype(np.float32)
    return dict(x=x, src=src, dst=dst, edge_attr=np.concatenate([bonds, bonds]),
                graph_id=np.concatenate(gid), num_nodes=off, num_graphs=graphs,
                y=rng.integers(0, 2, (graphs, 1)).astype(np.float32))


def mol_args(b, dev):
    import torch
    return [torch.tensor(b[k], device=dev) for k in ("x", "src", "dst", "edge_attr",
                                                     "graph_id")] + [b["num_nodes"],
                                                                     b["num_graphs"]]


def mol_phase(dev) -> None:
    """MolGNN at OGB's mol defaults (examples/graphproppred/mol/main_pyg.py:
    gin-virtual, 5 layers, emb 300, dropout 0.5, mean pooling, 1 task) on
    synthetic molecule batches (mol_batch): ms an Adam step (binary
    cross-entropy with logits, lr 1e-3) at 32 and 1,024 graphs; then each of
    gin/gcn x the 5 poolings at a tiny size on the card against the CPU:
    the eval output within 1e-5 and one train-mode step's gradients within
    1e-4 (each of its tensor's largest, or 1e-6 of the model's largest)."""
    import copy
    import torch
    import torch.nn.functional as F
    from falcon_ttdforgnns_torch.models.gin import MolGNN
    from falcon_ttdforgnns_torch.train.optim import adam_init, adam_update
    rng = np.random.default_rng(0)
    for graphs in (32, 1024):
        model = MolGNN(1, 9, emb_dim=300, num_layers=5, conv_type="gin", virtual_node=True,
                       pooling="mean", dropout=0.5,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        params = list(model.parameters())
        opt, one = adam_init(params), torch.ones((), device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        batches = [mol_batch(rng, graphs) for _ in range(MOL_STEPS + 1)]
        times = []
        for i, b in enumerate(batches):
            args, y = mol_args(b, dev), torch.tensor(b["y"], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = F.binary_cross_entropy_with_logits(model(*args, train=True, generator=gen), y)
            adam_update(params, torch.autograd.grad(loss, params), opt, 1e-3, one)
            loss = float(loss.detach())
            times.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(loss):
                raise AssertionError(f"MolGNN step {i} at {graphs} graphs: loss {loss}")
        atoms = np.mean([b["num_nodes"] / graphs for b in batches])
        bonds = np.mean([len(b["src"]) / 2 / graphs for b in batches])
        log(f"  MolGNN gin-virtual 5 x 300, {graphs} graphs a batch ({atoms:.1f} atoms, "
            f"{bonds:.1f} bonds a graph): {min(times[1:]):.2f} ms an Adam step after the first "
            f"({times[0]:.1f} ms), losses finite")
    b = mol_batch(np.random.default_rng(1), 6)
    b["graph_id"][b["graph_id"] == 5] = 4  # graph 5 left empty: a padding graph
    for conv in ("gin", "gcn"):
        for pooling in MolGNN.POOLINGS:
            cpu = MolGNN(2, 9, emb_dim=16, num_layers=2, conv_type=conv, virtual_node=True,
                         pooling=pooling, dropout=0.0,
                         generator=torch.Generator().manual_seed(2))
            gpu = copy.deepcopy(cpu).to(dev)
            with torch.no_grad():
                want = cpu(*mol_args(b, "cpu"))
                got = gpu(*mol_args(b, dev)).cpu()
            rel = float((got - want).abs().max() / want.abs().max())
            grads = []
            for model, d in ((gpu, dev), (cpu, "cpu")):
                out = model(*mol_args(b, d), train=True)
                grads.append([g.cpu() for g in torch.autograd.grad(out.square().sum(),
                                                                   list(model.parameters()))])
            top = max(float(g.abs().max()) for g in grads[1])
            gerr = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-2 * top)
                       for a, c in zip(*grads))
            ok = rel <= 1e-5 and gerr <= 1e-4
            log(f"  tiny MolGNN {conv}/{pooling}, card vs CPU: output rel {rel:.2e}, "
                f"gradients rel {gerr:.2e} {'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"MolGNN {conv}/{pooling} on the card and the CPU disagree")


def profiler_phase(dev) -> None:
    """The profiler harness' TTEmbeddingBenchmark at the products shapes on
    the main path's count of ids (937,984 uniform draws): check_forward's
    error, the forward ("gather": tt_fwd sorting its ids; "grouped": given
    the sort), the forward and backward, and the dense table's gather."""
    from falcon_ttdforgnns_torch.profiler import TTEmbeddingBenchmark
    bench = TTEmbeddingBenchmark(batch_size=IDS_PER_STEP, device=dev)
    fwd = bench.bench_forward()
    bwd, dense = bench.bench_backward(), bench.bench_dense_reference()
    log(f"  TTEmbeddingBenchmark at p=125,140,140 q=5,5,4 ranks 16,16 on {IDS_PER_STEP} ids: "
        f"check_forward max error {fwd['gather'].max_err:.3e}; forward gather "
        f"{fwd['gather'].forward_ms:.4f} ms, grouped {fwd['grouped'].forward_ms:.4f} ms; "
        f"fwd+bwd {bwd.forward_ms:.4f} ms; dense gather {dense.forward_ms:.4f} ms")


def collect_ids(batch):
    """collect_level_ids of a host batch, on the CPU."""
    import torch
    from falcon_ttdforgnns_torch.models.sage import collect_level_ids
    return collect_level_ids(torch.as_tensor(batch.seeds),
                             [torch.as_tensor(l) for l in batch.layers])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "falcon_ttdforgnns_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from falcon_ttdforgnns_torch.graph import _native
    from falcon_ttdforgnns_torch.ops import _build
    from falcon_ttdforgnns_torch.ops import tt_kernels as K
    t0 = time.perf_counter()
    # one compiler per source, all at once: nvcc for each CUDA source, the
    # host compiler for the native runtime
    built = _build.build_all(host=_build.HOST_SOURCES)
    for name in built:
        if name in _build.HOST_SOURCES:
            _native.library()
        else:
            _build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(os.path.relpath(so, here) for so, _ in built.values())}")
    for _, report in built.values():
        kernel = None
        for line in report.splitlines():  # one line per compiled kernel
            if "Function properties for" in line:
                kernel, spill = line.split("for", 1)[1].strip(), ""
            elif "spill" in line and kernel:
                spill = line.strip()
            elif "registers" in line and kernel:
                short = re.search(
                    r"(?:tt_(?!kernels_cu)|tile_sum|window_gather|fanout_mean|adam_f32)\w+", kernel)
                log(f"  ptxas {short.group(0)[:44] if short else kernel}: "
                    f"{line.split(':', 1)[1].strip()}; {spill}")

    log("one B8 call, profiled:")
    if not in_own_process(here, "b8_profile_check"):
        log("  (three short profiles in that process: a second process)")
        if not in_own_process(here, "b8_profile_check"):
            raise AssertionError("one B8 call: no complete profile to check in two processes")
    torch.cuda.empty_cache()

    # the products graph, in its generator's order
    from falcon_ttdforgnns_torch.graph import get_dataset, reorder_permutation
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    t0 = time.perf_counter()
    ds0 = get_dataset("hard-ogbn-products", seed=0)
    log(f"dataset {ds0.name}: {ds0.num_nodes} nodes, {ds0.graph.num_edges} edges, "
        f"{time.perf_counter() - t0:.1f} s on the host (the native CSR builder)")

    log("full-graph GCN/GAT at full width (the arxiv recipe):")
    counts = {f"full-graph {k}": v for k, v in full_graph_phase(dev).items()}
    torch.cuda.empty_cache()

    perms = {}
    t0 = time.perf_counter()
    perms[0] = reorder_permutation(ds0.graph, 0, seed=0)
    log(f"(a) --partition 0 on hard-ogbn-products: {time.perf_counter() - t0:.1f} s on the host")
    ds = ds0.permute(perms[0])  # the flagship's --partition 0

    def config(**kw):
        return TrainConfig(p_shapes=(125, 140, 140), q_shapes=(5, 5, 4), lr=LR, **kw)

    log("the flagship's phases (nothing else running on the host):")
    other_b = main_path_phase(ds, config, K, dev, counts)
    table_phase(ds, config, dev, counts)
    log("--dist over one NCCL rank, the flagship's data-parallel step against its "
        "single-device step:")
    dist_phase(ds, config, dev, counts)
    log("C4, the mixed epoch's step groups:")
    c4_phase(ds, config, dev, counts)
    log("the baseline preset (--no-tt) and the TT flagship in f32:")
    baseline_phase(ds, config, dev, counts)
    log("--no-tt and --full-neighbor steps, card vs CPU on the tiny graph:")
    small_new_paths_check(dev)
    full_neighbor_phase(ds, config, K, dev, counts)
    log("--full-neighbor --node-shard over one NCCL rank, against --full-neighbor:")
    node_shard_phase(ds, config, dev, counts)
    log("the sampled GAT (gnnbench's gat-tt-products) at its published widths:")
    gat_phase(ds, dev, counts)

    # the two slow orderings start only after the phases whose host time is
    # read: --partition 128 in a thread (the native partitioner, one core),
    # -1 and -4 at arxiv in a process, beside the untimed checks of step 4
    part_job = start_partition(ds0.graph, 128)
    arxiv_job = start_own_process(here, "arxiv_orderings")
    log("python -m falcon_ttdforgnns_torch.cli with the slice's flags, started in a process "
        "of its own beside the untimed checks that follow, and read before the timed ones")
    cli_job = start_cli_flags(here)
    log("train step, card vs CPU (beside the --partition 128 thread and the arxiv orderings' "
        "process; nothing here is timed):")
    small_step_check(dev)
    small_puregpu_check(dev)
    small_full_graph_check(dev)
    log("(d) the cache's lifecycle, card vs CPU:")
    small_cache_check(dev)
    log("RGAT against the CPU on a tiny typed graph:")
    small_rgat_check(dev)
    torch.cuda.empty_cache()
    log("the CLI's flags (--autotune, --eval-sampled, --store-emb, --plot, --profile):")
    finish_cli_flags(cli_job)
    log("the bf16 fan-out mean's kernels against their plain versions:")
    tower_res = tower_kernel_check(dev)
    log("the full-graph means' kernels (C2's bf16, the f32 one, the bf16 product's) against "
        "their plain versions:")
    tower_res.update(segment_kernel_check(ds, dev))
    torch.cuda.empty_cache()
    log("the sampled GAT's CSR attention kernels against their plain version:")
    reset_counts()
    tower_res.update(gat_kernel_check(ds, dev))
    counts["gat kernel phase"] = launched()
    torch.cuda.empty_cache()
    log("the dense table's Adam kernel against adam_update's plain body:")
    tower_res.update(adam_kernel_check(dev))
    torch.cuda.empty_cache()
    log("tt_fwd, tt_fwd_sr and tt_grads at every rank of the tuner's box (C3):")
    rank_phase(dev)
    torch.cuda.empty_cache()
    log("the profiler harness (profiler.py):")
    profiler_phase(dev)
    torch.cuda.empty_cache()
    log("checkpoint of the puregpu flagship (save and restore seconds beside the partition "
        "thread):")
    checkpoint_phase(ds, config, dev)
    log("(a) the orderings: host seconds at arxiv (-1 and -4, one process beside the "
        "--partition 128 thread and step 4) and at products (128 in its thread beside the "
        "arxiv process and step 4; -2 and -3 alone, after both)")
    finish_own_process(arxiv_job, "arxiv_orderings")
    t0 = time.perf_counter()
    perms[128], part_s = join_partition(part_job)
    log(f"  --partition 128 on hard-ogbn-products (native k-way): {part_s:.1f} s on the host, "
        f"in its thread ({time.perf_counter() - t0:.1f} s waited for it here)")
    for code in (-2, -3):
        t0 = time.perf_counter()
        perms[code] = reorder_permutation(ds0.graph, code, seed=0)
        log(f"  --partition {code} on hard-ogbn-products: {time.perf_counter() - t0:.1f} s "
            f"on the host")
    log("(a) the locality of each ordering:")
    orderings_phase(ds0, perms, K, dev)
    ds128 = ds0.permute(perms[128])
    del ds0, perms
    log("(b) final-p on the 128-partitioned products graph:")
    final_p_phase(ds128, config, K, dev, counts)
    del ds128
    log("(c) the puregpu flagship with the cache:")
    puregpu_cache_phase(ds, config, K, dev, counts)
    torch.cuda.empty_cache()
    log("the autotuning preset:")
    autotune_phase(ds, dev)
    torch.cuda.empty_cache()
    log("RGAT at MAG240M's R-GAT widths on hard-ogbn-arxiv:")
    rgat_phase(dev)
    torch.cuda.empty_cache()
    log("MolGNN at OGB's mol defaults:")
    mol_phase(dev)
    torch.cuda.empty_cache()
    # step 3, in a process of its own, whose profiler sessions (the updates'
    # device times) are its first; the main path's profile is this
    # process's first (in_own_process; PERF.md §7)
    res = in_own_process(here, "kernel_phase")
    torch.cuda.empty_cache()

    others = [("sr", "--bf16 --bf16-sr --sparse", dict(sparse=True, bf16=True, bf16_sr=True),
               ("tt_fwd_sr", "tt_grads[bf16]", "tt_adam_apply")),
              ("sgd", "--sparse --tt-optimizer sgd", dict(sparse=True, tt_optimizer="sgd"),
               ("tt_fwd", "tt_grads", "tt_sgd_apply")),
              ("adagrad", "--sparse --tt-optimizer adagrad",
               dict(sparse=True, tt_optimizer="adagrad"),
               ("tt_fwd", "tt_grads", "tt_adagrad_apply")),
              ("rowwise", "--mode puregpu --sparse --tt-optimizer rowwise_adagrad",
               dict(mode="puregpu", sparse=True, tt_optimizer="rowwise_adagrad",
                    steps_per_call=STEPS_OTHER),
               ("tt_fwd", "tt_grads", "tt_adagrad_apply[rowwise]")),
              ("f32", "f32 --sparse (fused Adam)", dict(sparse=True),
               ("tt_fwd", "tt_grads", "tt_adam_apply")),
              ("dense", "f32 without --sparse (TTLookup, autograd through tt_grads)", {},
               ("tt_fwd", "tt_grads"))]
    for key, label, kw, must in others:
        log(f"{STEPS_OTHER} steps of {label}")
        if kw.get("mode") == "puregpu":
            tr = SageTrainer(cut(ds, STEPS_OTHER), config(**kw), device=dev)
            counts[key] = counted_epoch(tr, 0, key, must, STEPS_OTHER)
        else:
            tr = SageTrainer(ds, config(**kw), device=dev)
            counts[key] = counted_steps(tr, other_b, key, must)
        if key == "f32":
            log("evaluate() in f32 (--spmm xla: csr_mean_f32)")
            xla_accs, _ = checked_evaluate(tr, "f32 evaluate",
                                           must_launch=("tt_fwd", "csr_mean_f32"))
            f32_state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        del tr
        torch.cuda.empty_cache()

    log("evaluate() of the f32 weights through the SpMM kernels:")
    spmms, route_counts = sage_eval_routes(ds, config, f32_state, xla_accs, dev)
    counts.update({f"evaluate --spmm {k}": v for k, v in route_counts.items()})
    spmm_res, counts["kernel phase"] = spmm_kernel_phase(ds, spmms, dev)
    res.update(spmm_res)
    res.update(tower_res)
    log("the CLI under torchrun, --dist --multihost over one NCCL rank, started after the timed "
        "phases; beside it graft_entry's entry() and dryrun_multichip(1) on the card:")
    torchrun_job = start_torchrun_cli(here)
    dryrun_phase()
    finish_torchrun_cli(torchrun_job)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"total {time.perf_counter() - t_all:.0f} s")

    # each kernel's launches come from the run of the path that drives it;
    # spmm_tiled[bf16] and spmm_tile_partials[, bf16] are on no trainer path
    path_of = {"tt_fwd": "final-p", "tt_grads": "final-p", "tt_fwd[bf16]": "main",
               "tt_grads[bf16]": "main", "tt_adam_apply": "main", "tt_fwd_sr": "sr",
               "tt_sgd_apply": "sgd", "tt_adagrad_apply": "adagrad",
               "tt_adagrad_apply[rowwise]": "rowwise",
               "spmm_tiled": "evaluate --spmm pallas",
               "spmm_tiled[bf16]": "kernel phase", "spmm_tile_partials": "kernel phase",
               "spmm_tile_partials[bf16]": "kernel phase",
               "spmm_gather": "full-graph gcn blocked",
               "fanout_mean_bf16": "main", "fanout_mean_bf16[bwd]": "main",
               "segment_mean_bf16": "bf16 evaluate", "csr_mean_f32": "bf16 evaluate",
               "csr_mean_bf16": "bf16 evaluate",
               "csr_gat_bf16": "gat evaluate", "csr_gat_f32": "gat kernel phase",
               "adam_f32": "baseline"}
    kernels = [{"name": n, "route": "cuda",
                "source": (TT_SOURCE if n.startswith("tt_") else ATTN_SOURCE
                           if n.startswith("csr_gat") else OPTIM_SOURCE
                           if n.startswith("adam_") else TOWER_SOURCE
                           if n.startswith(("fanout_", "segment_", "csr_")) else SPMM_SOURCE),
                "replaces": REPLACES[n], "launches": counts[path_of[n]][n],
                "launched_by": path_of[n],
                "max_abs_err": res[n]["max_abs_err"], "ms": res[n]["ms"],
                "plain_ms": res[n]["plain_ms"], "bound_ms": res[n]["bound_ms"],
                "bound_by": res[n]["bound_by"], "library_ms": res[n]["library_ms"],
                **{k: res[n][k] for k in ("device_ms", "library_device_ms", "sort_ms",
                                          "kernel_ms", "index_add_ms") if k in res[n]}}
               for m in kernel_modules() for n in m.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.exit(rc)

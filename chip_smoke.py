#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (falcon_ttdforgnns_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from csrc/ (one nvcc per source, all at once)
   and times the build; profiles one B8 call on a random graph (one
   memset and one kernel, nothing else);
3. holds each TT kernel (and each variant: bf16 store, stochastically
   rounded store, bf16 d_out, SGD, adagrad, rowwise adagrad) against its
   plain PyTorch version at the main path's shapes (ogbn-products TT
   shapes, 937,984 ids per step from a seeded zipf draw) and at small 2-
   and 4-core shapes, and times kernel, plain version and, where one
   exists, the PyTorch library call for the same function; for the
   launch-sized updates (Adam, SGD, adagrad) also the device time per call
   from torch.profiler beside the loop time, for kernel and library call;
   for tt_grads the sort of its ids apart, the distinct ids and prefix
   runs that set its bound and the pieces and segments of its walk; times
   the host's two ways to read the current stream;
4. checks the train step on the card against the same step on the CPU
   (plain versions) on a tiny graph, for f32 --sparse, f32 without it,
   --bf16 --sparse, --bf16 --bf16-sr --sparse and each --tt-optimizer, and
   3 full-graph steps of GCN (--spmm xla and blocked) and GAT;
5. trains full-graph GCN (--spmm xla, --spmm blocked) and GAT at full
   width (3 layers x 256, GAT 3 heads) on the full-size hard-ogbn-arxiv
   graph, 3 steps each with the launch counters zeroed before and read
   after, then evaluate(); the blocked losses are held to the xla ones;
6. trains the full-width SAGE 3x256 on the full-size hard-ogbn-products
   graph: 5 steps of the main path, --bf16 --sparse (bf16 kernel I/O,
   fused Adam), each step's tt_grads walk counts and bound, with the launch
   counters zeroed before and read after (and the update's argument-cache
   misses: at most the first step's); a profiled window of 3 steps (device
   time by kernel, tt_grads with its sort); 5 steps sampled on the host as
   train_epoch does; tt_grads on those 5 steps' ids at 32, 64 and 128
   sorted positions a warp; then, each with the counters zeroed
   before and read after, 2 steps each of --bf16 --bf16-sr --sparse and
   --sparse --tt-optimizer sgd|adagrad|rowwise_adagrad, 2 f32 --sparse
   steps, 2 f32 steps without --sparse (TTLookup's backward kernel), and
   full-graph evaluate() in f32 and under bf16;
7. evaluate() of the f32 weights through --spmm pallas (B7) and --spmm
   blocked (B9): the host tiling timed apart, the accuracies held to the
   xla route's;
8. holds the SpMM kernels (B7 and B8 at D=100 and 256 in f32 and with
   bf16 compute at 256, B9 at 256) against their plain versions on the
   products graph, and times them beside torch.sparse.mm (B7, B8),
   index_select + mul (B9) and the xla route; holds one B8 call's peak
   memory to its output's;
9. prints the per-kernel JSON line, then the device line.

Step 3 runs after step 6's main path and its profile (see main()).

Exits non-zero, before printing any result, without a CUDA device or
outside a checkout of the repository; any failed check raises.
"""

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
SPMM_ROUTE_ACC = 1e-3  # --spmm pallas|blocked accuracies against xla's (argmax near-ties)
TT_SOURCE = "falcon_ttdforgnns_torch/csrc/tt_kernels.cu"
SPMM_SOURCE = "falcon_ttdforgnns_torch/csrc/spmm_kernels.cu"
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
    "spmm_gather": "falcon_ttdforgnns_tpu/ops/spmm_blocked.py:140"}
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
    calls in us, and {host op: device us of the kernels it launched} (the
    kernels of a library call such as aten::sort, whose names are not the
    port's)."""
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
    return ({e.key: (e.count, getattr(e, "self_device_time_total", 0))
             for e, card in zip(events, on_card) if card}, wall_us,
            {e.key: getattr(e, "device_time_total", 0)
             for e, card in zip(events, on_card) if not card})


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


def grouped_macs(shapes, per_id: int, per_prefix: int) -> int:
    """The multiply-adds of the grouped backward (the note in
    csrc/tt_kernels.cu): per id 2 L_{T-1} r_{T-1} q_{T-1} (the last core's
    gradient row and the chain gradient), per prefix
    3 sum_{k=1}^{T-2} L_k r_k q_k r_{k+1} (P_{T-2} recomputed, then the
    backward through cores T-2..1).  With (distinct ids, prefix runs) the
    work the function needs; with (pieces, segments) the work tt_grads'
    walk does, the chunk starts' splits included.  Exact at 3 cores; at 4
    an upper bound (a prefix that keeps d_1 keeps P_1)."""
    fr, q, T = shapes.full_ranks, shapes.q_shapes, shapes.ndim
    L = [int(np.prod(q[:k])) for k in range(T + 1)]
    seg = sum(L[k] * fr[k] * q[k] * fr[k + 1] for k in range(1, T - 1))
    return per_id * 2 * L[T - 1] * fr[T - 1] * q[T - 1] + per_prefix * 3 * seg


def grads_bound(shapes, counts: dict, d_size: int) -> tuple:
    """tt_grads' bound for these ids: the ids (4 B each) and d_out read
    once, the cores read and the gradient written once; the multiply-adds
    that the distinct ids and prefix runs need (grouped_macs)."""
    B, D = counts["ids"], shapes.embedding_dim
    return bound_ms(4 * B + d_size * B * D + 8 * shapes.num_tt_params,
                    2 * grouped_macs(shapes, counts["distinct"], counts["prefix_runs"]))


def walk_line(label: str, shapes, counts: dict) -> str:
    need = grouped_macs(shapes, counts["distinct"], counts["prefix_runs"])
    walk = grouped_macs(shapes, counts["pieces"], counts["segments"])
    return (f"{label}: {counts['ids']} ids, {counts['distinct']} distinct, "
            f"{counts['prefix_runs']} prefix runs, {need / 1e9:.4f} GMAC needed; tt_grads' "
            f"walk: {counts['pieces']} pieces, {counts['segments']} segments, "
            f"{walk / 1e9:.4f} GMAC")


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(K, shapes, cores, ids, d_out, full: bool):
    """Each kernel against its plain version on the same inputs; with
    `full`, also the times.  Returns per-kernel results."""
    import torch
    dev = ids.device
    res = {}
    seed = torch.tensor(20261016, dtype=torch.int32, device=dev)
    out = K.tt_fwd(shapes, cores, ids)
    res["tt_fwd"] = {"max_abs_err": check(
        "tt_fwd", [("out", out, K.tt_fwd_plain(shapes, cores, ids), "tt_fwd")])}
    del out
    res["tt_fwd[bf16]"] = {"max_abs_err": check_bf16(
        "tt_fwd[bf16]", K.tt_fwd(shapes, cores, ids, torch.bfloat16),
        K.tt_fwd_plain(shapes, cores, ids, torch.bfloat16))}
    res["tt_fwd_sr"] = {"max_abs_err": check_bf16(
        "tt_fwd_sr", K.tt_fwd_sr(shapes, cores, ids, seed),
        K.tt_fwd_sr_plain(shapes, cores, ids, seed))}
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

    def timed(name, kernel, plain, library, nbytes, flops, reps=10, plain_reps=3,
              on_device=False):
        """Loop ms of kernel, plain version and library call (CUDA events
        around `reps` calls back to back); with `on_device`, also the
        device ms per call of kernel and library call (torch.profiler)."""
        r = res[name]
        r.update(ms=cuda_ms(kernel, reps), plain_ms=cuda_ms(plain, plain_reps),
                 library_ms=None if library is None else cuda_ms(library, reps))
        if on_device:
            r.update(device_ms=device_ms(kernel),
                     library_device_ms=None if library is None else device_ms(library))
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops)

    timed("tt_fwd", lambda: K.tt_fwd(shapes, cores, ids),
          lambda: K.tt_fwd_plain(shapes, cores, ids), None,
          4 * (B + n_tt + B * D), 2 * macs_f * B)
    timed("tt_fwd[bf16]", lambda: K.tt_fwd(shapes, cores, ids, torch.bfloat16),
          lambda: K.tt_fwd_plain(shapes, cores, ids, torch.bfloat16), None,
          4 * (B + n_tt) + 2 * B * D, 2 * macs_f * B)
    # the ~12 integer operations of the hash per element are not counted
    timed("tt_fwd_sr", lambda: K.tt_fwd_sr(shapes, cores, ids, seed),
          lambda: K.tt_fwd_sr_plain(shapes, cores, ids, seed), None,
          4 * (B + n_tt + 1) + 2 * B * D, 2 * macs_f * B)
    # the bound from the multiply-adds that these ids' distinct ids and
    # prefix runs need (the atomics run in L2, not on the FMA pipes); the
    # log also gives the bound of the reference's per-id chain (22,400
    # multiply-adds an id at the products shapes), work the kernel no
    # longer does
    counts = K.grouped_counts(shapes, ids)
    log("  " + walk_line("the draw", shapes, counts))
    sort_ms = cuda_ms(lambda: K.grouped_order(ids), 10)
    chain_bound = {}
    for name, d, size in (("tt_grads", d_out, 4), ("tt_grads[bf16]", d_bf16, 2)):
        nbytes = 4 * B + size * B * D + 8 * n_tt
        timed(name, lambda d=d: K.tt_grads(shapes, cores, ids, d),
              lambda d=d: K.tt_grads_plain(shapes, cores, ids, d), None, nbytes,
              2 * grouped_macs(shapes, counts["distinct"], counts["prefix_runs"]))
        res[name]["sort_ms"] = sort_ms
        chain_bound[name] = bound_ms(nbytes, 2 * macs_b * B)[0]

    def params_with(gs):
        ps = [torch.nn.Parameter(c.clone()) for c in cores]
        for p, g in zip(ps, gs):
            p.grad = g.clone()
        return ps

    st, st_plain = state(), state()
    fused = torch.optim.Adam(params_with(grads), lr=LR, betas=(b1, b2), eps=eps, fused=True)
    timed("tt_adam_apply", lambda: K.tt_adam_apply(*st, grads, scal, b1, b2, eps),
          lambda: K.tt_adam_plain(*st_plain, grads, scal, b1, b2, eps), fused.step,
          4 * 7 * n_tt + 12, 12 * n_tt, reps=50, plain_reps=20, on_device=True)
    c_k, c_p, c_l = ([c.clone() for c in cores] for _ in range(3))
    timed("tt_sgd_apply", lambda: K.tt_sgd_apply(c_k, grads, LR),
          lambda: K.tt_sgd_plain(c_p, grads, LR),
          lambda: torch._foreach_add_(c_l, grads, alpha=-LR),
          4 * 3 * n_tt, 2 * n_tt, reps=50, plain_reps=20, on_device=True)
    ag_k, ag_p = acc_state(False), acc_state(False)
    adagrad = torch.optim.Adagrad(params_with(grads), lr=LR, eps=1e-10, foreach=True)
    timed("tt_adagrad_apply", lambda: K.tt_adagrad_apply(*ag_k, grads, LR, 1e-10),
          lambda: K.tt_adagrad_plain(*ag_p, grads, LR, 1e-10), adagrad.step,
          4 * 5 * n_tt, 7 * n_tt, reps=50, plain_reps=20, on_device=True)
    rw_k, rw_p = acc_state(True), acc_state(True)
    timed("tt_adagrad_apply[rowwise]",
          lambda: K.tt_adagrad_apply(*rw_k, grads, LR, 1e-8, True),
          lambda: K.tt_adagrad_plain(*rw_p, grads, LR, 1e-8, True), None,
          4 * 3 * n_tt + 4 * 2 * rows, 6 * n_tt, reps=50, plain_reps=20, on_device=True)

    def ms4(x, absent):
        return absent if x is None else f"{x:.4f} ms"

    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev = ""
        if "device_ms" in r:
            lib_dev = ms4(r["library_device_ms"],
                          "none" if r["library_ms"] is None else "not measured")
            dev = f"; on the device {ms4(r['device_ms'], 'not measured')}, library {lib_dev}"
        if name in chain_bound:
            dev += (f"; of it the sort {r['sort_ms']:.4f} ms; the per-id chain's bound "
                    f"{chain_bound[name]:.4f} ms")
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{lib} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}){dev}")
    return res


def kernel_phase(K, dev):
    """Step 3: the kernels at the products shapes and two small cases."""
    import torch
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
    for small in (TTShapes(256, 64, (16, 16), (8, 8), (12,)),
                  TTShapes(1296, 36, (6, 6, 6, 6), (2, 3, 3, 2), (6, 6, 6))):
        log(f"kernels at {small.ndim} cores, p={small.p_shapes}, 1001 ids:")
        c = [torch.tensor(x, device=dev) for x in tt_init.init_tt_cores(small, "normal", 1)]
        i = torch.tensor(rng.integers(0, small.num_embeddings, 1001).astype(np.int32), device=dev)
        g = torch.randn((1001, small.embedding_dim), generator=gen, device=dev)
        kernel_checks(K, small, c, i, g, full=False)
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
            if not math.isclose(float(lg), float(lc), rel_tol=2e-3 if bf16 else 1e-4):
                raise AssertionError(f"{kw} step {step}: loss on the card {float(lg)} "
                                     f"vs on the CPU {float(lc)}")
        offs = [(a.detach().cpu() - b.detach()).abs()
                for a, b in zip(gpu.model.parameters(), cpu.model.parameters())]
        err = max(float(o.max()) for o in offs)
        if bf16:
            share = max(float((o > 0.1 * LR).float().mean()) for o in offs)
            ok = share <= 0.05 and err <= 3 * 2 * LR + 1e-6
            what = f"share > 0.1 lr apart {share:.4f} (tol 0.05), max {err:.3e}"
        else:
            ok = err <= 3 * 1e-3 * LR
            what = f"max param diff {err:.3e} (tol {3 * 1e-3 * LR:.1e})"
        log(f"  tiny graph {kw}: 3 steps, loss card vs CPU ok, {what} "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{kw}: params on the card and on the CPU disagree")


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
    from falcon_ttdforgnns_torch.ops import spmm_blocked, spmm_tiled, tt_kernels
    return tt_kernels, spmm_tiled, spmm_blocked


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
    did so more often.  Returns the counts."""
    from falcon_ttdforgnns_torch.ops import tt_kernels
    reset_counts()
    train_steps(trainer, batches, label)
    counts = launched()
    updates = sum(counts.get(k, 0) for k in UPDATES)
    misses = tt_kernels.arg_cache_misses()
    log(f"  launches: {counts}; update argument sets validated anew: {misses} of "
        f"{updates} update launches")
    missing = [k for k in must_launch if not counts.get(k)]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: {counts}")
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
    t0 = time.perf_counter()
    trainer.evaluate()
    log(f"  {label}: {first:.0f} ms (first call, includes moving the edge list to "
        f"the card), second call {(time.perf_counter() - t0) * 1e3:.0f} ms, {accs}, "
        f"launches {counts}")
    missing = [k for k in must_launch if not counts.get(k)]
    if not all(0.0 <= a <= 1.0 for a in accs.values()) or missing:
        raise AssertionError(f"evaluate() gave {accs}, {missing} never launched")
    return accs, counts


def chunk_sweep(K, shapes, id_batches, dev) -> None:
    """tt_grads with a bf16 d_out, as on the main path, on the main path's
    own ids at 32, 64 and 128 sorted positions a warp (GRADS_CHUNK is
    chosen from these): loop ms per call of each batch, the chunks taking
    turns within a batch, and each chunk's pieces and segments."""
    import torch
    from falcon_ttdforgnns_torch.ops import tt_init
    cores = [torch.tensor(c, device=dev)
             for c in tt_init.init_tt_cores(shapes, "approx-normal", 0)]
    gen = torch.Generator(device=dev).manual_seed(1)
    chunks = (32, 64, 128)
    times = {c: [] for c in chunks}
    for ids in id_batches:
        d = torch.randn((ids.shape[0], shapes.embedding_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        for c in chunks:
            times[c].append(cuda_ms(lambda: K.tt_grads(shapes, cores, ids, d, chunk=c), 10))
    for c in chunks:
        walk = K.grouped_counts(shapes, id_batches[0], c)
        log(f"  tt_grads[bf16] at chunk {c}{' (GRADS_CHUNK)' if c == K.GRADS_CHUNK else ''}: "
            f"{', '.join(f'{t:.4f}' for t in times[c])} ms on the {len(id_batches)} steps' "
            f"ids (step 0: {walk['pieces']} pieces, {walk['segments']} segments)")


def profile_steps(trainer, batches) -> None:
    """Where a --sparse step's device time goes: torch.profiler over a few
    steps, kernels ranked by device time, and the device's busy share of
    the window's wall time.  A window in which the profiler missed a
    record of the TT kernels (one launch of each per step) is taken again,
    up to three times; after the third the breakdown is not measured."""
    n = len(batches)

    def steps():
        for b in batches:
            trainer.train_step(b.seeds, b.layers, b.labels)

    def complete(ops):
        tt = {re.search(r"tt_\w+_kernel<[^>]*>", k).group(0): c for k, (c, _) in ops.items()
              if "tt_fwd_kernel" in k or "tt_grads_kernel" in k}
        if sorted(tt.values()) != [n, n]:
            log(f"  TT kernel records {tt} for {n} steps")
        return sorted(tt.values()) == [n, n]

    ops, wall_us, under = complete_profile(steps, complete, f"{n} main-path steps")
    if ops is None:
        return
    rows = [(us, key, count) for key, (count, us) in ops.items()]
    busy_us = sum(r[0] for r in rows)
    log(f"  profiled {n} steps: {wall_us / n / 1e3:.1f} ms per step (profiler on), "
        f"device busy {busy_us / n / 1e3:.1f} ms per step = "
        f"{busy_us / wall_us:.1%} of wall")
    # tt_grads' time on the path is its kernel and the sort of its ids (the
    # step sorts nothing else on the card)
    kernel_us = sum(us for key, (_, us) in ops.items() if "tt_grads_kernel" in key)
    sort_us = under.get("aten::sort", 0)
    log(f"  tt_grads with its sort: {(kernel_us + sort_us) / n / 1e3:.3f} ms per step "
        f"(kernel {kernel_us / n / 1e3:.3f}, aten::sort's kernels {sort_us / n / 1e3:.3f})")
    for us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"    {us / n / 1e3:8.3f} ms/step {us / max(busy_us, 1e-9):6.1%}  "
            f"x{count // n:<3d} {key[:90]}")


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


def b8_profile_check(dev) -> None:
    """One B8 call on the card is one memset and one kernel, with no
    per-tile partials and no index_add_: torch.profiler over one call on a
    random dst-sorted graph (200,000 nodes, 10M edges, D=100; the launches
    do not depend on the size).  It runs in a process of its own
    (in_own_process).  A missing record can only hide work, so any device
    work other than the memset and the tile_sum kernel fails at once, and a
    profile short of the two is taken again, up to three times."""
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

    if complete_profile(lambda: P.spmm_sum_tile_partials(h, *args), complete,
                        "one B8 call")[0] is None:
        raise AssertionError("one B8 call: no complete profile to check")


def in_own_process(here: str, phase: str) -> None:
    """chip_smoke.<phase>(cuda) in a process of its own, whose output is
    logged; raises if it failed.  Its torch.profiler session is then that
    process's first: on the H100, sessions taken after a process's first
    have lost device records of the port's kernels (PERF.md §7)."""
    code = f"import torch, chip_smoke; chip_smoke.{phase}(torch.device('cuda'))"
    out = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True,
                         text=True, timeout=600)
    for line in out.stdout.splitlines():
        log(line)
    if out.returncode != 0:
        raise AssertionError(f"{phase} failed in its own process:\n{out.stderr[-3000:]}")


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

    from falcon_ttdforgnns_torch.ops import _build
    from falcon_ttdforgnns_torch.ops import tt_kernels as K
    t0 = time.perf_counter()
    built = _build.build_all()  # one nvcc per source, all at once
    for name in built:
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
                short = re.search(r"(?:tt_(?!kernels_cu)|tile_sum|window_gather)\w+",
                                  kernel)
                log(f"  ptxas {short.group(0)[:44] if short else kernel}: "
                    f"{line.split(':', 1)[1].strip()}; {spill}")

    log("one B8 call, profiled:")
    in_own_process(here, "b8_profile_check")
    torch.cuda.empty_cache()
    log("train step, card vs CPU:")
    small_step_check(dev)
    small_full_graph_check(dev)
    torch.cuda.empty_cache()

    log("full-graph GCN/GAT at full width (the arxiv recipe):")
    counts = {f"full-graph {k}": v for k, v in full_graph_phase(dev).items()}
    torch.cuda.empty_cache()

    from falcon_ttdforgnns_torch.graph import get_dataset, reorder_permutation
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    t0 = time.perf_counter()
    ds = get_dataset("hard-ogbn-products", seed=0)
    ds = ds.permute(reorder_permutation(ds.graph, 0, seed=0))
    log(f"dataset {ds.name}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
        f"{time.perf_counter() - t0:.1f} s on the host")

    def config(**kw):
        return TrainConfig(p_shapes=(125, 140, 140), q_shapes=(5, 5, 4), lr=LR, **kw)

    cfg = config(sparse=True, bf16=True)
    trainer = SageTrainer(ds, cfg, device=dev)
    t0 = time.perf_counter()
    batches = [b for _, b in zip(range(STEPS_MAIN + STEPS_OTHER), trainer.loader)]
    n_ids = sum(b.all_nodes.shape[0] for b in batches) // len(batches)
    log(f"sampled {len(batches)} batches of {cfg.batch_size} seeds, {n_ids} ids each, "
        f"{(time.perf_counter() - t0) * 1e3 / len(batches):.1f} ms per batch on the host")
    main_b, other_b = batches[:STEPS_MAIN], batches[STEPS_MAIN:]

    log(f"main path: {STEPS_MAIN} --bf16 --sparse steps (bf16 kernel I/O, fused Adam), "
        f"SAGE {cfg.num_layers}x{cfg.hidden_dim}")
    main_ids = [torch.as_tensor(b.all_nodes.astype(np.int32), device=dev) for b in main_b]
    for i, ids in enumerate(main_ids):
        walk = K.grouped_counts(trainer.shapes, ids)
        bound, by = grads_bound(trainer.shapes, walk, 2)
        log(f"  {walk_line(f'step {i}', trainer.shapes, walk)}; tt_grads' bound (bf16 "
            f"d_out) {bound:.4f} ms by {by}")
    counts["main"] = counted_steps(trainer, main_b, "bf16 sparse",
                                   ("tt_fwd[bf16]", "tt_grads[bf16]", "tt_adam_apply"))
    profile_steps(trainer, main_b[:3])
    # what train_epoch does per batch: sample on the host, then step
    loader_it = iter(trainer.loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS_MAIN):
        b = next(loader_it)
        float(trainer.train_step(b.seeds, b.layers, b.labels)[0])
    per_step = (time.perf_counter() - t0) / STEPS_MAIN
    log(f"  sample + step, as in train_epoch: {per_step * 1e3:.1f} ms per step, "
        f"{cfg.batch_size / per_step:.0f} seeds/s")
    chunk_sweep(K, trainer.shapes, main_ids, dev)
    del main_ids
    log("evaluate() under bf16: full-graph propagation over every node and edge")
    checked_evaluate(trainer, "bf16 evaluate")
    del trainer
    torch.cuda.empty_cache()
    # step 3 runs here, so that the main path's profile is this process's
    # first profiler session (in_own_process; PERF.md §7)
    res = kernel_phase(K, dev)
    torch.cuda.empty_cache()

    others = [("sr", "--bf16 --bf16-sr --sparse", dict(sparse=True, bf16=True, bf16_sr=True),
               ("tt_fwd_sr", "tt_grads[bf16]", "tt_adam_apply")),
              ("sgd", "--sparse --tt-optimizer sgd", dict(sparse=True, tt_optimizer="sgd"),
               ("tt_fwd", "tt_grads", "tt_sgd_apply")),
              ("adagrad", "--sparse --tt-optimizer adagrad",
               dict(sparse=True, tt_optimizer="adagrad"),
               ("tt_fwd", "tt_grads", "tt_adagrad_apply")),
              ("rowwise", "--sparse --tt-optimizer rowwise_adagrad",
               dict(sparse=True, tt_optimizer="rowwise_adagrad"),
               ("tt_fwd", "tt_grads", "tt_adagrad_apply[rowwise]")),
              ("f32", "f32 --sparse (fused Adam)", dict(sparse=True),
               ("tt_fwd", "tt_grads", "tt_adam_apply")),
              ("dense", "f32 without --sparse (TTLookup, autograd through tt_grads)", {},
               ("tt_fwd", "tt_grads"))]
    for key, label, kw, must in others:
        log(f"{STEPS_OTHER} steps of {label}")
        tr = SageTrainer(ds, config(**kw), device=dev)
        counts[key] = counted_steps(tr, other_b, key, must)
        if key == "f32":
            log("evaluate() in f32 (--spmm xla: index_add_)")
            xla_accs, _ = checked_evaluate(tr, "f32 evaluate")
            f32_state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        del tr
        torch.cuda.empty_cache()

    log("evaluate() of the f32 weights through the SpMM kernels:")
    spmms, route_counts = sage_eval_routes(ds, config, f32_state, xla_accs, dev)
    counts.update({f"evaluate --spmm {k}": v for k, v in route_counts.items()})
    spmm_res, counts["kernel phase"] = spmm_kernel_phase(ds, spmms, dev)
    res.update(spmm_res)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"total {time.perf_counter() - t_all:.0f} s")

    # each kernel's launches come from the run of the path that drives it;
    # spmm_tiled[bf16] and spmm_tile_partials[, bf16] are on no trainer path
    path_of = {"tt_fwd": "f32", "tt_grads": "f32", "tt_fwd[bf16]": "main",
               "tt_grads[bf16]": "main", "tt_adam_apply": "main", "tt_fwd_sr": "sr",
               "tt_sgd_apply": "sgd", "tt_adagrad_apply": "adagrad",
               "tt_adagrad_apply[rowwise]": "rowwise",
               "spmm_tiled": "evaluate --spmm pallas",
               "spmm_tiled[bf16]": "kernel phase", "spmm_tile_partials": "kernel phase",
               "spmm_tile_partials[bf16]": "kernel phase",
               "spmm_gather": "full-graph gcn blocked"}
    kernels = [{"name": n, "route": "cuda",
                "source": TT_SOURCE if n.startswith("tt_") else SPMM_SOURCE,
                "replaces": REPLACES[n], "launches": counts[path_of[n]][n],
                "launched_by": path_of[n],
                "max_abs_err": res[n]["max_abs_err"], "ms": res[n]["ms"],
                "plain_ms": res[n]["plain_ms"], "bound_ms": res[n]["bound_ms"],
                "bound_by": res[n]["bound_by"], "library_ms": res[n]["library_ms"],
                **{k: res[n][k] for k in ("device_ms", "library_device_ms", "sort_ms")
                   if k in res[n]}}
               for m in kernel_modules() for n in m.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (falcon_ttdforgnns_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from csrc/ and times the build;
3. holds each kernel against its plain PyTorch version at the main path's
   shapes (ogbn-products TT shapes, 937,984 ids per step from a seeded
   zipf draw) and at small 2- and 4-core shapes, and times kernel, plain
   version and, where one exists, the PyTorch library call for the same
   function;
4. checks the train step on the card against the same step on the CPU
   (plain versions) on a tiny graph;
5. trains the full-width SAGE 3x256 on the full-size hard-ogbn-products
   graph: 5 steps with --sparse (fused Adam, the main path), with the
   launch counters zeroed before and read after; a profiled window of 3
   steps (device time by kernel); 5 steps sampled on the host as
   train_epoch does; then 2 steps without --sparse (TTLookup's backward
   kernel) and one full-graph evaluate();
6. prints the per-kernel JSON line, then the device line.

Exits non-zero, before printing any result, without a CUDA device or
outside a checkout of the repository; any failed check raises.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H100_F32_FLOPS = 67e12      # f32 outside the tensor cores (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
ZIPF_A = 1.3
STEPS_SPARSE = 5
STEPS_DENSE = 2
# Kernel-vs-plain tolerances on max|kernel - plain| / max|plain|, each
# tensor judged on its own scale (each core's gradient; each core's m, v
# and change of the core value):
#   tt_fwd: 16-term f32 dots, FMA vs the plain version's bmm order;
#   tt_grads: atomics reorder sums of up to ~2.3e5 terms (the hottest zipf
#     id is 25% of the batch), sqrt(n) * 2^-24 ~ 3e-5;
#   tt_adam_apply m, v: the same elementwise formula, FMA contraction only;
#   tt_adam_apply core change (new core - old core): when the two updates
#     differ by an ulp, the new cores may round apart by one ulp of the core
#     (3e-8 at |core| 0.38), ~1.6e-5 of the largest change (~1.9e-3).
TOL = {"tt_fwd": 1e-5, "tt_grads": 1e-4, "tt_adam_apply": 1e-5,
       "tt_adam_apply core change": 1e-4}


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


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(K, shapes, cores, ids, d_out, full: bool):
    """Each kernel against its plain version on the same inputs; with
    `full`, also the times.  Returns per-kernel results."""
    import torch
    dev = ids.device
    res = {}
    out = K.tt_fwd(shapes, cores, ids)
    res["tt_fwd"] = {"max_abs_err": check(
        "tt_fwd", [("out", out, K.tt_fwd_plain(shapes, cores, ids), "tt_fwd")])}
    del out
    grads = K.tt_grads(shapes, cores, ids, d_out)
    want = K.tt_grads_plain(shapes, cores, ids, d_out)
    res["tt_grads"] = {"max_abs_err": check(
        "tt_grads", [(f"core {k}", g, w, "tt_grads")
                     for k, (g, w) in enumerate(zip(grads, want))])}
    b1, b2, eps = 0.9, 0.999, 1e-8
    scal = torch.tensor([3e-3, 1 / (1 - b1 ** 3), 1 / (1 - b2 ** 3)], device=dev)
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
    if not full:
        return res

    B, D, n_tt = ids.shape[0], shapes.embedding_dim, shapes.num_tt_params
    macs_f, macs_b = chain_macs(shapes)
    res["tt_fwd"].update(
        ms=cuda_ms(lambda: K.tt_fwd(shapes, cores, ids), 10),
        plain_ms=cuda_ms(lambda: K.tt_fwd_plain(shapes, cores, ids), 3),
        library_ms=None)
    res["tt_fwd"]["bound_ms"], res["tt_fwd"]["bound_by"] = bound_ms(
        4 * (B + n_tt + B * D), 2 * macs_f * B)
    res["tt_grads"].update(
        ms=cuda_ms(lambda: K.tt_grads(shapes, cores, ids, d_out), 10),
        plain_ms=cuda_ms(lambda: K.tt_grads_plain(shapes, cores, ids, d_out), 3),
        library_ms=None)
    # the chain's multiply-adds only; the 1,424 scatter adds per id are
    # atomics that run in L2, not on the FMA pipes
    res["tt_grads"]["bound_ms"], res["tt_grads"]["bound_by"] = bound_ms(
        4 * (B + B * D + 2 * n_tt), 2 * macs_b * B)
    st, st_plain = state(), state()
    res["tt_adam_apply"].update(
        ms=cuda_ms(lambda: K.tt_adam_apply(*st, grads, scal, b1, b2, eps), 50),
        plain_ms=cuda_ms(lambda: K.tt_adam_plain(*st_plain, grads, scal, b1, b2, eps), 20))
    params = [torch.nn.Parameter(c.clone()) for c in cores]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    fused = torch.optim.Adam(params, lr=3e-3, betas=(b1, b2), eps=eps, fused=True)
    res["tt_adam_apply"]["library_ms"] = cuda_ms(fused.step, 50)
    res["tt_adam_apply"]["bound_ms"], res["tt_adam_apply"]["bound_by"] = bound_ms(
        4 * 7 * n_tt + 12, 12 * n_tt)
    for name, r in res.items():
        log(f"  {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
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
    on the CPU (plain versions), on a tiny graph with dropout off."""
    import torch
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5,
                                feat_dim=64, seed=1)
    for sparse in (True, False):
        cfg = TrainConfig(batch_size=128, fanouts=(3, 4), hidden_dim=32, num_layers=2,
                          tt_ranks=(8, 8), dropout=0.0, sparse=sparse, seed=1)
        gpu, cpu = SageTrainer(ds, cfg, device=dev), SageTrainer(ds, cfg, device="cpu")
        for step, batch in zip(range(3), gpu.loader):
            lg, _ = gpu.train_step(batch.seeds, batch.layers, batch.labels)
            lc, _ = cpu.train_step(batch.seeds, batch.layers, batch.labels)
            if not math.isclose(float(lg), float(lc), rel_tol=1e-4):
                raise AssertionError(f"step {step}: loss on the card {float(lg)} "
                                     f"vs on the CPU {float(lc)}")
        # Adam's normalised steps: a near-cancelled gradient element may
        # differ by a fraction of lr (tests/test_torch_tt_ops.py)
        err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(gpu.model.parameters(), cpu.model.parameters()))
        log(f"  tiny graph, sparse={sparse}: 3 steps, card vs CPU loss rel_tol 1e-4 ok, "
            f"max param diff {err:.3e} (tol {3 * 1e-3 * cfg.lr:.1e})")
        if not err <= 3 * 1e-3 * cfg.lr:
            raise AssertionError("params on the card and on the CPU disagree")


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


def profile_steps(trainer, batches) -> None:
    """Where a --sparse step's device time goes: torch.profiler over a few
    steps, kernels ranked by device time, and the device's busy share of
    the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step(b.seeds, b.layers, b.labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0), e.key, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(r[0] for r in rows)
    n = len(batches)
    log(f"  profiled {n} steps: {wall_us / n / 1e3:.1f} ms per step (profiler on), "
        f"device busy {busy_us / n / 1e3:.1f} ms per step = "
        f"{busy_us / wall_us:.1%} of wall")
    for us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"    {us / n / 1e3:8.3f} ms/step {us / max(busy_us, 1e-9):6.1%}  "
            f"x{count // n:<3d} {key[:90]}")


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
    so, report = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(so, here)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    res = kernel_phase(K, dev)
    torch.cuda.empty_cache()
    log("train step, card vs CPU:")
    small_step_check(dev)

    from falcon_ttdforgnns_torch.graph import get_dataset, reorder_permutation
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    t0 = time.perf_counter()
    ds = get_dataset("hard-ogbn-products", seed=0)
    ds = ds.permute(reorder_permutation(ds.graph, 0, seed=0))
    log(f"dataset {ds.name}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
        f"{time.perf_counter() - t0:.1f} s on the host")
    cfg = TrainConfig(p_shapes=(125, 140, 140), q_shapes=(5, 5, 4), sparse=True)
    trainer = SageTrainer(ds, cfg, device=dev)
    t0 = time.perf_counter()
    batches = [b for _, b in zip(range(STEPS_SPARSE + STEPS_DENSE), trainer.loader)]
    n_ids = sum(b.all_nodes.shape[0] for b in batches) // len(batches)
    log(f"sampled {len(batches)} batches of {cfg.batch_size} seeds, {n_ids} ids each, "
        f"{(time.perf_counter() - t0) * 1e3 / len(batches):.1f} ms per batch on the host")

    log(f"main path: {STEPS_SPARSE} --sparse steps (fused Adam), SAGE "
        f"{cfg.num_layers}x{cfg.hidden_dim}")
    K.reset_launch_counts()
    train_steps(trainer, batches[:STEPS_SPARSE], "sparse")
    main_counts = K.launch_counts()
    log(f"  launches: {main_counts}")
    if min(main_counts.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {main_counts}")
    profile_steps(trainer, batches[:3])
    # what train_epoch does per batch: sample on the host, then step
    loader_it = iter(trainer.loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS_SPARSE):
        b = next(loader_it)
        float(trainer.train_step(b.seeds, b.layers, b.labels)[0])
    per_step = (time.perf_counter() - t0) / STEPS_SPARSE
    log(f"  sample + step, as in train_epoch: {per_step * 1e3:.1f} ms per step, "
        f"{cfg.batch_size / per_step:.0f} seeds/s")

    log(f"{STEPS_DENSE} steps without --sparse (TTLookup, autograd through tt_grads)")
    dense = SageTrainer(ds, TrainConfig(p_shapes=(125, 140, 140), q_shapes=(5, 5, 4)),
                        device=dev)
    K.reset_launch_counts()
    train_steps(dense, batches[STEPS_SPARSE:], "dense")
    counts = K.launch_counts()
    log(f"  launches: {counts}")
    if counts["tt_fwd"] == 0 or counts["tt_grads"] == 0:
        raise AssertionError(f"TTLookup did not run its kernels: {counts}")
    del dense
    torch.cuda.empty_cache()

    log("evaluate(): full-graph propagation over every node and edge")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accs = trainer.evaluate()
    log(f"  {(time.perf_counter() - t0) * 1e3:.0f} ms (first call, includes moving "
        f"the edge list to the card) {accs} launches {K.launch_counts()}")
    t0 = time.perf_counter()
    trainer.evaluate()
    log(f"  second call {(time.perf_counter() - t0) * 1e3:.0f} ms")
    if not all(0.0 <= a <= 1.0 for a in accs.values()) or K.launch_counts()["tt_fwd"] == 0:
        raise AssertionError(f"evaluate() gave {accs}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"total {time.perf_counter() - t_all:.0f} s")

    sources = {"tt_fwd": "falcon_ttdforgnns_tpu/ops/tt_pallas.py:255",
               "tt_grads": "falcon_ttdforgnns_tpu/ops/tt_pallas.py:280",
               "tt_adam_apply": "falcon_ttdforgnns_tpu/ops/tt_pallas.py:378"}
    kernels = [{"name": n, "route": "cuda",
                "source": "falcon_ttdforgnns_torch/csrc/tt_kernels.cu",
                "replaces": sources[n], "launches": main_counts[n],
                "max_abs_err": res[n]["max_abs_err"], "ms": res[n]["ms"],
                "plain_ms": res[n]["plain_ms"], "bound_ms": res[n]["bound_ms"],
                "bound_by": res[n]["bound_by"], "library_ms": res[n]["library_ms"]}
               for n in ("tt_fwd", "tt_grads", "tt_adam_apply")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

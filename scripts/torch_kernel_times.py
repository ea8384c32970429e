#!/usr/bin/env python3
"""Time the port's TT lookup and gradient kernels, and with --spmm its tiled
SpMMs, at the products shapes.

    python3 scripts/torch_kernel_times.py [--root DIR] [--spmm]
        [--graph-cache FILE] [--save FILE] [--against FILE]

Imports ``falcon_ttdforgnns_torch`` from DIR (default: the checkout this
script sits in), builds its kernels, and times the lookup's three stores
(``tt_fwd`` f32 and bf16, ``tt_fwd_sr``) and ``tt_grads`` (f32 and bf16
``d_out``; with the ids' sort apart where that checkout sorts them, and
the lookup's kernel with the sort given where it takes one) on the inputs
chip_smoke.py uses: ogbn-products TT shapes (p=125,140,140, q=5,5,4, ranks
16,16) and 937,984 ids from a seeded zipf(1.3) draw; all of them also on
937,984 uniform ids (779K distinct, near the main path's sampled batches:
720K).  ``--save FILE`` writes four lookup outputs (f32 on both draws,
bf16 on the uniform draw, SR on the zipf draw) to FILE (torch.save);
``--against FILE`` counts the values of this checkout's outputs whose bits
differ from those saved, so two checkouts' lookups can be compared bit for
bit.  It also times the two adagrad updates of the cores,
``tt_adagrad_apply`` per element and ``[rowwise]`` (one accumulator per
p-row), on the products cores with random gradients: loop ms and the
device ms per call from torch.profiler.  With
``--spmm`` it also times, on the full-size hard-ogbn-products graph with the
trainer's tilings (chip_smoke.py's): B7
(``spmm_sum_tiled_uniform``) at D=100, D=256 and bf16 compute at 256, B8
(``spmm_sum_tile_partials``) at the same three, and ``torch.sparse.mm``
(CSR) at each.  ``--graph-cache FILE`` keeps the graph's edge list in an
.npz file so that later runs skip building it.  Prints the ptxas register
report of the build and one JSON line with the card's name, power limit and
the mean ms of each kernel over back-to-back launches (CUDA events).  Run
it from two checkouts in one call, in turns, to compare two versions of the
kernels on one card.  Needs a CUDA device.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np


def ms(fn, reps=20):
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=50):
    """Device time per call of fn() in ms: the kernels' time from
    torch.profiler over `reps` calls after one warm-up; a profile with fewer
    kernel records than calls is taken again, and None returned after
    three (torch.profiler has lost device records, PERF.md §7)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if sum(e.count for e in on_card) >= reps:
            return sum(getattr(e, "self_device_time_total", 0) for e in on_card) / reps / 1e3
    return None


def adagrad_times(K, cores):
    """Loop ms and device ms of tt_adagrad_apply, per element and rowwise."""
    import torch
    gen = torch.Generator(device=cores[0].device).manual_seed(2)
    grads = [torch.randn(c.shape, generator=gen, device=c.device) for c in cores]
    times = {}
    for rowwise, name in ((False, "tt_adagrad_apply"), (True, "tt_adagrad_apply[rowwise]")):
        cs = [c.clone() for c in cores]
        accs = [torch.zeros(c.shape[:1] if rowwise else c.shape, device=c.device)
                for c in cores]

        def call():
            K.tt_adagrad_apply(cs, accs, grads, 1e-3, 1e-8 if rowwise else 1e-10, rowwise)

        times[name] = ms(call, 50)
        times[f"{name} device"] = device_ms(call)
    return times


def bits(t):
    """The raw bits of a float tensor, to compare two of them bit for bit."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def products_edges(cache):
    """The hard-ogbn-products graph as chip_smoke.py builds it (reordered
    with partition 0): (num_nodes, src, dst), dst-sorted."""
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return int(z["n"]), z["src"], z["dst"]
    from falcon_ttdforgnns_torch.graph import get_dataset, reorder_permutation
    ds = get_dataset("hard-ogbn-products", seed=0)
    ds = ds.permute(reorder_permutation(ds.graph, 0, seed=0))
    src, dst = ds.graph.to_coo()
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    if cache:
        os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
        np.savez(cache, n=ds.num_nodes, src=src, dst=dst)
    return ds.num_nodes, src, dst


def spmm_times(cache):
    import torch
    from falcon_ttdforgnns_torch.ops import spmm_tiled as P
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n, src, dst = products_edges(cache)
    e_t = P.auto_tile_edges(len(src), n)
    tu = P.build_spmm_tiles_uniform(src, dst, n, tile_edges=e_t,
                                    tiles_per_chunk=max(256, (1 << 30) // (e_t * 256 * 2)))
    flat = P.build_spmm_tiles(src, dst, n, tile_edges=e_t)
    print(f"graph and tilings: {time.perf_counter() - t0:.1f} s on the host", flush=True)
    uni = [torch.as_tensor(a, device=dev) for a in (tu.src, tu.dstl, tu.w, tu.blkl, tu.blk0)]
    umeta = (tu.num_blocks_padded, tu.blocks_per_chunk, tu.block_rows, e_t, n)
    fl = [torch.as_tensor(a, device=dev) for a in (flat.src, flat.dstl, flat.w, flat.blk)]
    fmeta = (flat.num_blocks, flat.block_rows, e_t, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    crow = torch.as_tensor(indptr, device=dev)
    col = torch.as_tensor(src.astype(np.int64), device=dev)
    del src, dst, tu, flat
    gen = torch.Generator(device=dev).manual_seed(11)
    times = {}
    for label, D, cd in (("D=100", 100, torch.float32), ("D=256", 256, torch.float32),
                         ("bf16 D=256", 256, torch.bfloat16)):
        h = torch.randn((n, D), generator=gen, device=dev)
        times[f"spmm_tiled {label}"] = ms(
            lambda: P.spmm_sum_tiled_uniform(h, *uni, *umeta, compute_dtype=cd), 5)
        times[f"spmm_tile_partials {label}"] = ms(
            lambda: P.spmm_sum_tile_partials(h, *fl, *fmeta, compute_dtype=cd), 5)
        A = torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], device=dev, dtype=cd),
                                    size=(n, n))
        hh = h.to(cd)
        times[f"torch.sparse.mm {label}"] = ms(lambda: torch.sparse.mm(A, hh), 5)
        del h, hh, A
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--spmm", action="store_true")
    ap.add_argument("--graph-cache", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from falcon_ttdforgnns_torch.ops import _build, tt_init
    from falcon_ttdforgnns_torch.ops import tt_kernels as K
    from falcon_ttdforgnns_torch.ops.tt_shapes import make_tt_shapes

    for src_name in _build.SOURCES:
        _, report = _build.build(src_name)
        name = None
        for line in report.splitlines():
            if "Function properties for" in line:
                name = line.split("for", 1)[1].strip()
            elif "registers" in line and name:
                print(f"ptxas {name[:70]}: {line.split(':', 1)[1].strip()}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    shapes = make_tt_shapes(2_449_029, 100, (16, 16), (125, 140, 140), (5, 5, 4))
    rng = np.random.default_rng(0)
    cores = [torch.tensor(c, device=dev)
             for c in tt_init.init_tt_cores(shapes, "approx-normal", 0)]
    B = 1024 * (1 + 15 + 150 + 750)
    perm = rng.permutation(shapes.num_embeddings)
    ids = torch.tensor(perm[(rng.zipf(1.3, B) - 1) % shapes.num_embeddings]
                       .astype(np.int32), device=dev)
    d_out = torch.randn((B, shapes.embedding_dim), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    d_bf16 = d_out.to(torch.bfloat16)
    uni = torch.tensor(rng.integers(0, shapes.num_embeddings, B).astype(np.int32), device=dev)
    seed = torch.tensor(20261016, dtype=torch.int32, device=dev)
    takes_order = "order" in inspect.signature(K.tt_fwd).parameters
    lookups = {"tt_fwd": lambda i, **kw: K.tt_fwd(shapes, cores, i, **kw),
               "tt_fwd[bf16]": lambda i, **kw: K.tt_fwd(shapes, cores, i, torch.bfloat16, **kw),
               "tt_fwd_sr": lambda i, **kw: K.tt_fwd_sr(shapes, cores, i, seed, **kw)}

    times = {}
    for draw, i in (("", ids), (" uniform", uni)):
        order = K.grouped_order(i) if takes_order else None
        for name, fn in lookups.items():
            times[name + draw] = ms(lambda: fn(i))
            if takes_order:
                times[f"{name}{draw} kernel"] = ms(lambda: fn(i, order=order))
        del order
    times.update({"tt_grads": ms(lambda: K.tt_grads(shapes, cores, ids, d_out)),
                  "tt_grads[bf16]": ms(lambda: K.tt_grads(shapes, cores, ids, d_bf16)),
                  "tt_grads[bf16] uniform": ms(lambda: K.tt_grads(shapes, cores, uni, d_bf16))})
    times.update(adagrad_times(K, cores))
    if hasattr(K, "grouped_order"):
        times["tt_grads sort"] = ms(lambda: K.grouped_order(ids))
        times["sort uniform"] = ms(lambda: K.grouped_order(uni))
    outs = {"tt_fwd": lookups["tt_fwd"](ids), "tt_fwd uniform": lookups["tt_fwd"](uni),
            "tt_fwd[bf16] uniform": lookups["tt_fwd[bf16]"](uni),
            "tt_fwd_sr": lookups["tt_fwd_sr"](ids)}
    differ = None
    if args.against:
        saved = torch.load(args.against)
        differ = {k: int((bits(v) != bits(saved[k].to(dev))).sum()) for k, v in outs.items()}
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        torch.save({k: v.cpu() for k, v in outs.items()}, args.save)
    del outs
    if args.spmm:
        times.update(spmm_times(args.graph_cache))
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "chunk": getattr(K, "GRADS_CHUNK", None),
                      "fwd_chunk": getattr(K, "FWD_CHUNK", None), "ms": times,
                      "values_differing_from_saved": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

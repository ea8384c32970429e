#!/usr/bin/env python3
"""Where a restored final-p trainer parts from the original on the card.

    python3 scripts/restore_drift.py

On the full-size hard-ogbn-products graph in its --partition 0 order,
final-p's trainer (f32, routed Adam, --use-cached --cache-size 100000,
rowwise adagrad on the cache rows, --mode mixed) takes 40 warmup steps,
the populate and 10 cached steps; it is saved, and two fresh trainers
restore the file.  All three then take the same 5 batches, the dropout
generator reseeded alike.  After each step it prints, for the original
against a restored trainer and for the two restored ones against each
other, the four parameters furthest apart (in units of lr, with the
count of elements past 3e-3 lr); at the end the quantiles of the cache
rows' sqrt(accumulator) and that of every row past 3e-3 lr.  A row whose
rowwise-adagrad step lr * g / sqrt(acc) is normalised by a tiny gradient
turns the atomics' other order of its sum into a share of lr.  Needs a
CUDA device; run from the root of a checkout (writes and removes
checkpoints/restore_drift/).
"""

import dataclasses
import os
import shutil
import sys

import numpy as np

LR = 3e-3
CKPT = os.path.join("checkpoints", "restore_drift")


def worst(a, b, k: int = 4) -> list:
    rows = []
    for (name, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        off = (x.detach() - y.detach()).abs()
        rows.append((float(off.max()) / LR, name, int((off > 3e-3 * LR).sum())))
    return [f"{n} {m:.4f} lr ({c} past 3e-3 lr)" for m, n, c in sorted(rows, reverse=True)[:k]]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("restore_drift: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    from falcon_ttdforgnns_torch.graph import get_dataset, reorder_permutation, sampler
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig
    dev = torch.device("cuda")
    ds = get_dataset("hard-ogbn-products", seed=0)
    ds = ds.permute(reorder_permutation(ds.graph, 0, seed=0))
    cfg = TrainConfig(p_shapes=(125, 140, 140), q_shapes=(5, 5, 4), lr=LR, cache_size=100_000)
    picks = np.random.default_rng(8).permutation(ds.train_idx)
    warm, fresh = np.sort(picks[:40 * 1024]), np.sort(picks[40 * 1024:50 * 1024])

    def trainer():
        return SageTrainer(dataclasses.replace(ds, train_idx=warm), cfg, device=dev)

    original = trainer()
    original.train_epoch(0)
    original.maybe_populate_cache()
    batches = [b for _, b in zip(range(10), sampler.NeighborLoader(
        ds.graph, fresh, ds.labels, cfg.fanouts, cfg.batch_size, seed=1))]
    for b in batches:
        original.train_step(b.seeds, b.layers, b.labels)
    shutil.rmtree(CKPT, ignore_errors=True)
    path = original.save(CKPT)
    copies = [trainer() for _ in range(2)]
    for t in copies:
        t.restore(path)
    shutil.rmtree(CKPT, ignore_errors=True)
    trainers = [original, *copies]
    for t in trainers:
        t.dropout_gen.manual_seed(cfg.seed + 1000 + 2)
    for step, b in enumerate(batches[:5]):
        for t in trainers:
            t.train_step(b.seeds, b.layers, b.labels)
        print(f"step {step}: original vs restored: {worst(original, copies[0])}", flush=True)
        print(f"step {step}: restored vs restored: {worst(copies[0], copies[1])}", flush=True)
    r = original.cache_opt.acc.sqrt()
    q = np.quantile(r.cpu().numpy(), [0.0, 0.01, 0.1, 0.5, 0.9, 1.0])
    print("cache rows' sqrt(acc) quantiles 0/1/10/50/90/100%: "
          + ", ".join(f"{v:.3e}" for v in q))
    off = (original.model.embed.cache_weight.detach()
           - copies[0].model.embed.cache_weight.detach()).abs()
    bad = torch.nonzero((off > 3e-3 * LR).any(1)).reshape(-1)
    print(f"cache rows past 3e-3 lr: {bad.numel()}, their sqrt(acc): "
          f"{[f'{float(r[i]):.3e}' for i in bad[:20]]}, largest "
          f"{float(off.max()) / LR:.4f} lr")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a --mode puregpu step on the card parts from the CPU's.

    python3 scripts/puregpu_divergence.py

On chip_smoke.py's tiny graph (3,000 nodes, f32 --sparse, dropout 0),
three steps run side by side: --mode puregpu on the card (sampling on the
card), --mode mixed on the card and --mode mixed on the CPU, both fed the
layers the card sampled.  After each step it prints the losses and, for
every parameter more than 1e-6 apart between two of the three, the largest
difference, how many elements lie beyond 3e-3 lr, and that element's value
and Adam moments (m, v) on each side: a v near 1e-20 marks a near-cancelled
gradient, which Adam's step, no longer normalised there, turns into a
difference of a share of lr.  Needs a CUDA device; run from the root of a
checkout.
"""

import os
import sys

import numpy as np


def state(tr):
    """{name: (value, Adam m, Adam v)} of every parameter, on the CPU."""
    dense = [n for n, _ in tr.model.named_parameters() if not n.startswith("embed.")]
    out = {}
    for n, p in tr.model.named_parameters():
        if n.startswith("embed."):
            k = int(n.rsplit("_", 1)[1])
            m, v = tr.tt_opt.m[k], tr.tt_opt.v[k]
        else:
            i = dense.index(n)
            m, v = tr.opt_state.m[i], tr.opt_state.v[i]
        out[n] = (p.detach().cpu(), m.detach().cpu(), v.detach().cpu())
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("puregpu_divergence: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as C
    from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset
    from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, lr = torch.device("cuda"), C.LR
    ds = hard_synthetic_dataset(num_nodes=3000, avg_degree=6, num_classes=5, feat_dim=64, seed=1)
    order = np.random.default_rng(1).permutation(ds.train_idx)
    cfg = TrainConfig(batch_size=128, fanouts=(3, 4), hidden_dim=32, num_layers=2,
                      tt_ranks=(8, 8), dropout=0.0, seed=1, lr=lr, mode="puregpu", sparse=True)
    mixed = TrainConfig(**{**cfg.__dict__, "mode": "mixed"})
    gpu, gmix = SageTrainer(ds, cfg, device=dev), SageTrainer(ds, mixed, device=dev)
    cpu = SageTrainer(ds, mixed, device="cpu")
    kept = C.tap_sampler(gpu)
    for step in range(3):
        pick = order[step * 128:(step + 1) * 128]
        seeds, labels = pick.astype(np.int32), ds.labels[pick].astype(np.int32)
        lg, _ = gpu.device_train_step(torch.as_tensor(seeds, device=dev),
                                      torch.as_tensor(labels, device=dev))
        layers = [l.cpu() for l in kept[-1][1]]
        lm, _ = gmix.train_step(seeds, layers, labels)
        lc, _ = cpu.train_step(seeds, layers, labels)
        print(f"step {step}: loss puregpu {float(lg):.8f} card mixed {float(lm):.8f} "
              f"cpu {float(lc):.8f}")
        sg, sm, sc = state(gpu), state(gmix), state(cpu)
        for n in sc:
            for label, ours, base in (("puregpu-cpu", sg, sc), ("cardmixed-cpu", sm, sc),
                                      ("puregpu-cardmixed", sg, sm)):
                d = (ours[n][0] - base[n][0]).abs()
                if float(d.max()) > 1e-6:
                    i = int(d.argmax())
                    at = [(float(ours[n][j].reshape(-1)[i]), float(base[n][j].reshape(-1)[i]))
                          for j in range(3)]
                    print(f"  {label} {n}: max {float(d.max()):.3e} at {i}, "
                          f"{int((d > 3e-3 * lr).sum())} beyond 3e-3 lr; p {at[0][0]:.6e} vs "
                          f"{at[0][1]:.6e}; m {at[1][0]:.3e} vs {at[1][1]:.3e}; "
                          f"v {at[2][0]:.3e} vs {at[2][1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

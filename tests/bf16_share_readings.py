"""Readings of test_three_certified_bf16_steps_track_jax's statistic over
trainer seeds and both host samplers.

    python tests/bf16_share_readings.py [--seeds 8]

For each sampler (the port's numpy path, then its native one) and each
trainer seed, runs the test's body: three --bf16 --sparse steps of the JAX
trainer and of the port on the port loader's batches, from the same
initial variables, on the test's tiny graph.  Prints one JSON line a run:
the largest relative loss difference, the largest parameter difference in
units of lr, and the parameter with the largest share of elements more
than 0.1 lr apart, with that share.  Runs on the CPU, a few seconds a run.

Readings with the port's bf16 fan-out mean rounding its partial sums as
the JAX package's does (ROADMAP C1, closed), seeds 0-7 on both samplers:
no element of any parameter more than 0.1 lr apart in all 16 runs; the
largest difference 0.031 lr (native, seed 2); losses within 1.34e-4
relative (numpy, seed 0).  Before that fix the worst share read 1.9-11.6%
(numpy) and 0.4-10.6% (native), the largest difference up to 4.0 lr and
the losses up to 5.8e-4 apart.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from falcon_ttdforgnns_tpu.graph import hard_synthetic_dataset as jax_hard  # noqa: E402
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer  # noqa: E402
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig  # noqa: E402

from falcon_ttdforgnns_torch.convert import load_jax_variables  # noqa: E402
from falcon_ttdforgnns_torch.graph import hard_synthetic_dataset, sampler  # noqa: E402
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig  # noqa: E402

LR = 0.003


def reading(ds, jds, seed: int) -> dict:
    tiny = dict(batch_size=64, fanouts=(3, 3), hidden_dim=16, num_layers=2,
                tt_ranks=(4, 4), dropout=0.0, lr=LR, seed=seed, sparse=True, bf16=True)
    jtr = JaxTrainer(jds, JaxConfig(steps_per_call=1, **tiny))
    tr = SageTrainer(ds, TrainConfig(**tiny), device="cpu")
    load_jax_variables(tr, jax.tree.map(np.asarray, jtr.variables))
    rel = []
    for _, b in zip(range(3), tr.loader):
        jtr.variables, jtr.opt_state, jl, _ = jtr._step_fn(
            jtr.variables, jtr.opt_state, jnp.asarray(b.seeds),
            [jnp.asarray(l) for l in b.layers], jnp.asarray(b.labels), jax.random.PRNGKey(0))
        loss, _ = tr.train_step(b.seeds, b.layers, b.labels)
        rel.append(abs(float(loss) - float(jl)) / abs(float(jl)))
    params = jax.tree.map(np.asarray, jtr.variables["params"])
    ours = dict(tr.model.named_parameters())
    pairs = {f"tt_core_{k}": (ours[f"embed.tt_core_{k}"], params["embed"][f"tt_core_{k}"])
             for k in range(len(tr.cores))}
    for i in range(2):
        pairs[f"conv_{i}.self"] = (ours[f"convs.{i}.lin_self.weight"],
                                   params[f"conv_{i}"]["self"]["kernel"].T)
        pairs[f"conv_{i}.neigh"] = (ours[f"convs.{i}.lin_neigh.weight"],
                                    params[f"conv_{i}"]["neigh"]["kernel"].T)
    off = {n: np.abs(a.detach().numpy() - b) for n, (a, b) in pairs.items()}
    shares = {n: float((o > 0.1 * LR).mean()) for n, o in off.items()}
    worst = max(shares, key=shares.get)
    return dict(seed=seed, loss_rel_max=max(rel),
                max_off_lr=max(float(o.max()) for o in off.values()) / LR,
                worst=worst, worst_share=shares[worst])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    kw = dict(num_nodes=2000, avg_degree=5, num_classes=4, feat_dim=16, seed=0)
    ds, jds = hard_synthetic_dataset(**kw), jax_hard(**kw)
    native = sampler._native
    for name, handle in (("numpy", None), ("native", native)):
        sampler._native = handle
        for seed in range(args.seeds):
            print(json.dumps(dict(sampler=name, **reading(ds, jds, seed))), flush=True)


if __name__ == "__main__":
    main()

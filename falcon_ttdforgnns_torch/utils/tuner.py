"""TT-rank autotuning: ``minimize`` and ``tune_tt_rank`` of
``falcon_ttdforgnns_tpu/utils/tuner.py``, copied (numpy only).

Parity with the reference's nevergrad tuner (`tuning_SAGE.py:213-240`:
CMA/PSO over integer tt_rank in [2, 256], objective = 1/avg_throughput,
budget 20).  Where nevergrad is not installed the engine is a
self-contained (1+lambda) evolution strategy over integer log-scale rank
steps, whose history for a seed is the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TuneResult:
    best_params: Dict[str, int]
    best_value: float
    history: List[Tuple[Dict[str, int], float]] = field(default_factory=list)


def _nevergrad_minimize(objective, space, budget, seed):  # pragma: no cover
    import nevergrad as ng

    params = {k: ng.p.Scalar(lower=lo, upper=hi).set_integer_casting()
              for k, (lo, hi) in space.items()}
    inst = ng.p.Instrumentation(**params)
    opt = ng.optimizers.CMA(parametrization=inst, budget=budget)
    rec = opt.minimize(lambda **kw: objective(kw))
    return TuneResult(dict(rec.kwargs), float(rec.loss or 0.0))


def minimize(
    objective: Callable[[Dict[str, int]], float],
    space: Dict[str, Tuple[int, int]],
    budget: int = 20,
    seed: int = 0,
    engine: str = "auto",
) -> TuneResult:
    """Minimize ``objective`` over integer box ``space``.

    engine: auto | nevergrad | es
    """
    if engine in ("auto", "nevergrad"):
        try:
            return _nevergrad_minimize(objective, space, budget, seed)
        except ImportError:
            if engine == "nevergrad":
                raise

    # (1+lambda)-ES with multiplicative mutation, log-scale steps
    rng = np.random.default_rng(seed)
    keys = list(space.keys())

    def clip(p):
        return {k: int(np.clip(p[k], *space[k])) for k in keys}

    cur = clip({k: int(round(math.sqrt(lo * hi)))
                for k, (lo, hi) in space.items()})
    cur_val = objective(cur)
    history = [(dict(cur), cur_val)]
    lam = 3
    evals = 1
    sigma = 0.5
    while evals < budget:
        cands = []
        for _ in range(min(lam, budget - evals)):
            cand = clip({
                k: int(round(cur[k] * math.exp(sigma * rng.normal()))) + rng.integers(-1, 2)
                for k in keys})
            cand = clip(cand)
            v = objective(cand)
            evals += 1
            history.append((dict(cand), v))
            cands.append((v, cand))
        best_v, best_c = min(cands, key=lambda t: t[0])
        if best_v < cur_val:
            cur, cur_val = best_c, best_v
            sigma = min(1.0, sigma * 1.2)
        else:
            sigma = max(0.1, sigma * 0.8)
    best = min(history, key=lambda t: t[1])
    return TuneResult(best[0], best[1], history)


def tune_tt_rank(train_fn: Callable[[Sequence[int]], float], budget: int = 20,
                 rank_range: Tuple[int, int] = (2, 256), seed: int = 0,
                 engine: str = "auto") -> TuneResult:
    """The reference objective: minimize 1/avg_throughput over tt_rank
    (`tuning_SAGE.py:213-240`).  ``train_fn(ranks)`` returns throughput."""

    def objective(p: Dict[str, int]) -> float:
        tput = train_fn((p["r1"], p["r2"]))
        return 1.0 / max(tput, 1e-9)

    return minimize(objective, {"r1": rank_range, "r2": rank_range},
                    budget=budget, seed=seed, engine=engine)

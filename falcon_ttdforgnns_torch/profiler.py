"""Micro-benchmark and profiling harness of the TT lookup.

Port of ``falcon_ttdforgnns_tpu/profiler.py`` (a re-design of the
reference's ``sage_profiler.py``): the synthetic sparse-feature generator
(``:71-100``), the TT lookup micro-benchmark (``:246-500``, its
correctness assertions enabled) and the traced training steps
(``:599-787``).  Times come from CUDA events (``utils/metrics.device_timing``)
and traces from ``torch.profiler``; the benchmarks time the card and raise
without one, while :meth:`TTEmbeddingBenchmark.check_forward` also runs on
the CPU (the kernels' plain versions).

The JAX harness times two lookups, a gather and ``tt_lookup_grouped``
(the Efficient-TT prefix deduplication).  The port has no counterpart of
``tt_lookup_grouped``: ``tt_fwd`` already walks the ids sorted, computing
each prefix's chain once a run, so "gather" here is ``tt_fwd`` sorting
its ids itself and "grouped" is ``tt_fwd`` given that sort
(``grouped_order``) in advance.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import make_tt_shapes, tt_init
from .ops.tt_kernels import grouped_order, tt_fwd, tt_lookup_fused
from .ops.tt_lookup import tt_to_full
from .utils import resolve_device
from .utils.metrics import device_timing, profile_trace


def generate_sparse_feature(
    batch_size: int,
    num_embeddings: int,
    pooling_factor: float = 10.0,
    pooling_factor_std: float = 2.0,
    unique: bool = False,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic EmbeddingBag input: Gaussian bag lengths, random ids
    (``sage_profiler.py:71-100``).  Returns (indices, offsets)."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(
        rng.normal(pooling_factor, pooling_factor_std, batch_size), 1
    ).astype(np.int64)
    total = int(lengths.sum())
    indices = rng.choice(num_embeddings, size=total, replace=not unique)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return indices.astype(np.int64), offsets


@dataclass
class BenchResult:
    name: str
    forward_ms: float
    backward_ms: Optional[float] = None
    max_err: Optional[float] = None


class TTEmbeddingBenchmark:
    """Forward and backward time of the TT lookup against a dense table,
    with the dense-reference correctness check (the assertions at
    ``sage_profiler.py:303-305, 365-367, 425-426``, enabled)."""

    def __init__(self, batch_size: int = 1024,
                 p_shapes: Sequence[int] = (125, 140, 140),
                 q_shapes: Sequence[int] = (5, 5, 4),
                 ranks: Sequence[int] = (16, 16), seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.shapes = make_tt_shapes(int(np.prod(p_shapes)), int(np.prod(q_shapes)),
                                     tuple(ranks), tuple(p_shapes), tuple(q_shapes))
        self.cores = [torch.tensor(c, device=self.device)
                      for c in tt_init.init_tt_cores(self.shapes, "normal", seed)]
        self.batch_size = batch_size
        rng = np.random.default_rng(seed)
        self.idx = torch.tensor(
            rng.integers(0, self.shapes.num_embeddings, batch_size).astype(np.int32),
            device=self.device)

    def _time(self, fn, *args, warmup: int = 10, reps: int = 50) -> float:
        """Mean ms a call on the card (CUDA events; raises on the CPU)."""
        return device_timing(fn, *args, warmup=warmup, reps=reps, device=self.device)

    def check_forward(self, atol: float = 1e-3) -> float:
        """The lookup (``tt_fwd``, sorting its ids or given their sort)
        against the rows of the materialised table: the largest absolute
        difference, which must be under ``atol``."""
        with torch.no_grad():
            ref = tt_to_full(self.shapes, self.cores).index_select(0, self.idx.long())
            errs = [float((tt_fwd(self.shapes, self.cores, self.idx, order=order)
                           - ref).abs().max())
                    for order in (None, grouped_order(self.idx))]
        for name, err in zip(("gather", "grouped"), errs):
            if not err < atol:  # a check, kept under python -O
                raise AssertionError(f"{name} forward mismatch {err}")
        return max(errs)

    def bench_forward(self) -> Dict[str, BenchResult]:
        """ms a lookup of the batch: "gather" sorts its ids in the call,
        "grouped" is given their sort."""
        err = self.check_forward()
        order = grouped_order(self.idx)
        runs = (("gather", lambda: tt_fwd(self.shapes, self.cores, self.idx)),
                ("grouped", lambda: tt_fwd(self.shapes, self.cores, self.idx, order=order)))
        with torch.no_grad():
            return {name: BenchResult(name, self._time(fn), max_err=err) for name, fn in runs}

    def bench_backward(self) -> BenchResult:
        """ms a forward and backward of the lookup through autograd
        (``tt_fwd``, then ``tt_grads`` for the gradient of sum(out * 1))."""
        g = torch.ones((self.batch_size, self.shapes.embedding_dim), device=self.device)
        cores = [c.detach().requires_grad_(True) for c in self.cores]

        def step():
            out = tt_lookup_fused(self.shapes, cores, self.idx)
            return torch.autograd.grad((out * g).sum(), cores)

        return BenchResult("fwd+bwd", self._time(step))

    def bench_dense_reference(self) -> BenchResult:
        """ms the same rows take from a dense (num_embeddings, D) table."""
        table = torch.tensor(np.random.default_rng(0).normal(
            size=(self.shapes.num_embeddings, self.shapes.embedding_dim)).astype(np.float32),
            device=self.device)
        idx = self.idx.long()
        return BenchResult("dense", self._time(lambda: table.index_select(0, idx)))


def profile_training_step(trainer, out_dir: str, steps: int = 5) -> None:
    """A ``torch.profiler`` trace of ``steps`` train steps on the loader's
    batches, written into ``out_dir`` (``utils/metrics.profile_trace``)."""
    batches = list(itertools.islice(iter(trainer.loader), steps))
    with profile_trace(out_dir):
        for b in batches:
            loss, _ = trainer.train_step(b.seeds, b.layers, b.labels)
        float(loss)  # waits for the steps

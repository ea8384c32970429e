"""Throughput, model size and access analytics (port of ``throughput``,
``model_size_mb``, ``access_percentages`` and ``cumulative_access_curve``
of ``falcon_ttdforgnns_tpu/utils/metrics.py``)."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def throughput(num_samples: int, seconds: float) -> float:
    return num_samples / max(seconds, 1e-9)


def model_size_mb(tensors: Iterable[torch.Tensor]) -> float:
    """Bytes of ``tensors`` (e.g. a module's parameters) in MB (1e6)."""
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


def access_percentages(access_counts, top_fracs: Tuple[float, ...] = (0.01, 0.05, 0.1, 0.2, 0.5)
                       ) -> Dict[float, float]:
    """Share of all accesses served by the top-x hottest rows, for each x of
    ``top_fracs``: the skew that motivates the LFU cache."""
    counts = np.sort(np.asarray(access_counts))[::-1].astype(np.float64)
    total = counts.sum()
    if total == 0:
        return {f: 0.0 for f in top_fracs}
    cum = np.cumsum(counts)
    n = len(counts)
    return {f: float(cum[max(1, int(f * n)) - 1] / total) for f in top_fracs}


def cumulative_access_curve(access_counts, points: int = 100
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(share of rows, share of accesses) at ``points`` shares of the rows,
    hottest first: the access CDF."""
    counts = np.sort(np.asarray(access_counts))[::-1].astype(np.float64)
    cum = np.cumsum(counts) / max(counts.sum(), 1.0)
    xs = np.linspace(0, 1, points)
    idx = np.clip((xs * len(counts)).astype(int), 0, len(counts) - 1)
    return xs, cum[idx]

"""Throughput and access analytics (port of ``throughput`` and
``access_percentages`` of ``falcon_ttdforgnns_tpu/utils/metrics.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def throughput(num_samples: int, seconds: float) -> float:
    return num_samples / max(seconds, 1e-9)


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

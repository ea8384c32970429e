"""Throughput helper (port of the throughput part of
``falcon_ttdforgnns_tpu/utils/metrics.py``)."""

from __future__ import annotations


def throughput(num_samples: int, seconds: float) -> float:
    return num_samples / max(seconds, 1e-9)

"""Observability helpers: throughput, memory, timing, tracing and access
analytics (port of ``falcon_ttdforgnns_tpu/utils/metrics.py``: parity with
the reference's ``utils.py:21-51`` memory_usage, count_nnz and
give_throughput, ``utils.py:162-194`` access-percentage analytics and
``utils.py:196-220`` gpu_timing).  Timing uses CUDA events and tracing
``torch.profiler``; the plots are drawn only where matplotlib is
installed, as in the reference."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def throughput(num_samples: int, seconds: float) -> float:
    return num_samples / max(seconds, 1e-9)


def edges_per_second(num_edges_processed: int, seconds: float) -> float:
    """The BASELINE.json scaling metric."""
    return num_edges_processed / max(seconds, 1e-9)


def device_timing(fn: Callable, *args, warmup: int = 10, reps: int = 100,
                  device: Optional[torch.device] = None) -> float:
    """Mean ms a call of ``fn(*args)`` on a CUDA device (the reference's
    gpu_timing: 10 warmup calls, then 100 timed), from CUDA events around
    the timed calls on the current stream.  Raises without a CUDA device: a
    host clock would time the CPU's kernels, not the card's."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"device_timing times a CUDA device, not {device}")
    with torch.cuda.device(device):
        for _ in range(1 + warmup):
            fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Allocated and peak device bytes (MB) of each CUDA device, from
    ``torch.cuda.memory_stats``; empty without one (the reference's
    ``th.cuda.max_memory_allocated``, ``sage_dgl_partition.py:112``)."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6}
    return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, device activity), written as a Chrome trace into ``log_dir``
    (``trace_<pid>_<ns>.json``); without ``log_dir`` the block runs as it
    is."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is not
    installed (the plots are optional, as in the reference)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_access_cdf(access_counts, path: str) -> bool:
    """The access CDF as a figure at ``path`` (``utils.py:176-194``);
    returns whether a file was written (not without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return False
    xs, ys = cumulative_access_curve(access_counts)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(xs * 100, ys * 100)
    ax.set_xlabel("top % of rows")
    ax.set_ylabel("% of accesses")
    ax.set_title("embedding access skew")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def degree_histogram(degrees, bins: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Log-binned degree distribution (``graphloader.py:188-207``): the bin
    edges and the count of nodes in each."""
    degrees = np.asarray(degrees)
    dmax = max(int(degrees.max()), 1)
    edges = np.unique(np.round(np.logspace(0, np.log10(dmax + 1), bins)).astype(np.int64))
    hist, _ = np.histogram(degrees, bins=edges)
    return edges, hist


def plot_degree_distribution(degrees, path: str) -> bool:
    """The degree histogram on log axes at ``path``; returns whether a file
    was written (not without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return False
    edges, hist = degree_histogram(degrees)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.loglog(edges[:-1] + 1, hist + 1)
    ax.set_xlabel("degree")
    ax.set_ylabel("#nodes")
    ax.set_title("degree distribution")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def count_nnz(indices) -> Dict[str, float]:
    """A batch's ids (``utils.py:21-33`` count_nnz): total ids, distinct ids
    and the duplication factor, what a lookup that deduplicates saves."""
    idx = np.asarray(indices).reshape(-1)
    uniq = np.unique(idx)
    return {"nnz": int(idx.size), "unique": int(uniq.size),
            "dup_factor": float(idx.size / max(uniq.size, 1))}


def max_batch_size(num_nodes: int, feat_dim: int, hidden_dim: int, fanouts,
                   device_bytes: Optional[int] = None, dtype_bytes: int = 4,
                   safety: float = 0.5) -> int:
    """The largest seed batch whose dense-fanout activations fit
    ``safety`` of ``device_bytes`` (``utils.py:45-51``, re-derived for
    this memory model): each seed has sum over levels of prod(fanouts[:l])
    rows of max(feat, hidden) values, twice for the backward.
    ``device_bytes`` defaults to the current CUDA device's memory."""
    if device_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("max_batch_size needs device_bytes without a CUDA device")
        device_bytes = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    per_seed_rows = rows = 1
    for f in reversed(list(fanouts)):
        rows *= f
        per_seed_rows += rows
    bytes_per_seed = per_seed_rows * max(feat_dim, hidden_dim) * dtype_bytes * 2
    return max(1, int(device_bytes * safety / bytes_per_seed))

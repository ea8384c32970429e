"""Node reordering (``--partition``), port of
``falcon_ttdforgnns_tpu/graph/reorder.py``: the default ``partition == 0``
random permutation only.  The locality-aware orderings (k-way, recursive
TT-matched, RCMK, degree, louvain) are ROADMAP A5."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .csr import CSRGraph


def random_permutation(graph: CSRGraph, seed: int = 0) -> np.ndarray:
    """partition == 0 (`graphloader.py:443-446`)."""
    return np.random.default_rng(seed).permutation(graph.num_nodes).astype(np.int64)


def reorder_permutation(graph: CSRGraph, partition: int,
                        levels: Optional[Sequence[int]] = None,
                        seed: int = 0) -> np.ndarray:
    """Permutation (new id per old node) for the ``--partition`` flag."""
    if partition == 0:
        return random_permutation(graph, seed)
    raise NotImplementedError(f"--partition {partition} is not ported yet "
                              f"(ROADMAP A5); only 0 (random) is")

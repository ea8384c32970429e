"""ctypes bindings of the native host runtime (``csrc/falcon_native.cpp``).

Port of ``falcon_ttdforgnns_tpu/graph/_native.py``.  The library is built
at the first call of any function here (``ops/_build.build_host``, into
``falcon_ttdforgnns_torch/build/``), never at import; a missing compiler or
a failed build raises.  The callers (``csr.py``, ``sampler.py``,
``reorder.py``) take these paths as the JAX package does when its library
loads, so that both packages give the same arrays for the same seeds.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "build_csr": [_i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _i64p,
                  _i32p],
    "sample_neighbors": [_i64p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_uint64, _i32p],
    "sample_block_multi": [_i64p, _i32p, _i64p, ctypes.c_int64, _i32p, ctypes.c_int32,
                           ctypes.c_uint64, _i32p],
    "partition_kway": [_i64p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
                       _i32p],
    "rmat_edges": [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, _i64p, _i64p],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The runtime, built if it has not been yet, with every function's
    argument types declared.  ctypes releases the GIL for each call."""
    from ..ops import _build

    lib = ctypes.CDLL(str(_build.build_host("falcon_native")))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.falcon_native_version.restype = ctypes.c_int
    return lib


def version() -> int:
    return library().falcon_native_version()


def _seed(seed: int) -> int:
    return seed & (2**64 - 1)


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int,
              add_reverse: bool = True):
    """In-neighbour CSR by a threaded counting sort; each row sorted."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if len(src) != len(dst):
        raise ValueError(f"src and dst differ in length: {len(src)} and {len(dst)}")
    e = len(src) * (2 if add_reverse else 1)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    indices = np.empty(e, dtype=np.int32)
    library().build_csr(src, dst, len(src), num_nodes, int(add_reverse), indptr, indices)
    return indptr, indices


def sample_neighbors(indptr: np.ndarray, indices: np.ndarray,
                     nodes: np.ndarray, fanout: int, seed: int) -> np.ndarray:
    """(M,) nodes -> (M, fanout) in-neighbours, uniform with replacement;
    an isolated node samples itself."""
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    out = np.empty((len(nodes), fanout), dtype=np.int32)
    library().sample_neighbors(np.ascontiguousarray(indptr, np.int64),
                               np.ascontiguousarray(indices, np.int32),
                               nodes, len(nodes), fanout, _seed(seed), out)
    return out


def sample_block_multi(indptr: np.ndarray, indices: np.ndarray,
                       seeds: np.ndarray, fanouts, seed: int):
    """Every level of the fan-out tree in one call: a list of per-level
    arrays [(B, f1), (B, f1*f2), ...]."""
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    B = len(seeds)
    fo = np.ascontiguousarray(fanouts, dtype=np.int32)
    sizes, m = [], B
    for f in fanouts:
        m *= int(f)
        sizes.append(m)
    out = np.empty(sum(sizes), dtype=np.int32)
    library().sample_block_multi(np.ascontiguousarray(indptr, np.int64),
                                 np.ascontiguousarray(indices, np.int32),
                                 seeds, B, fo, len(fanouts), _seed(seed), out)
    levels, off = [], 0
    for s in sizes:
        levels.append(out[off:off + s].reshape(B, -1))
        off += s
    return levels


def rmat_edges(num_nodes: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """R-MAT edges without self loops.  Each thread's chunk is seeded, so
    the edges depend on the host's core count, as the JAX package's do."""
    src = np.empty(num_edges, dtype=np.int64)
    dst = np.empty(num_edges, dtype=np.int64)
    library().rmat_edges(num_nodes, num_edges, _seed(seed), a, b, c, src, dst)
    return src, dst


def partition_kway(indptr: np.ndarray, indices: np.ndarray, k: int,
                   seed: int = 0) -> np.ndarray:
    """Multilevel k-way partition (METIS-style): the part of every node."""
    n = len(indptr) - 1
    out = np.empty(n, dtype=np.int32)
    library().partition_kway(np.ascontiguousarray(indptr, np.int64),
                             np.ascontiguousarray(indices, np.int32),
                             n, k, _seed(seed), out)
    return out

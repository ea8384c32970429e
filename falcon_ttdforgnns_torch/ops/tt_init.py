"""TT-core initialization schemes (host-side numpy).

Capability parity with the reference's init machinery:
- weight distributions of ``reset_parameters``
  (`FBTT/tt_embeddings_ops.py:629-808`): uniform / naive-uniform / normal /
  approx-normal / approx-uniform (saw-tooth);
- random-orthogonal init (`tt_utils.py:117-155` ``get_ortho``);
- TT-SVD of a full matrix (`tt_utils.py:157-201` ``tt_matrix_decomp``),
  used for the eigen/dortho schemes where the decomposed matrix comes from
  a spectral embedding of the graph (`tt_utils.py:102-115` ``get_eigen``).

All functions return a list of numpy cores with OUR layout
``(p_k, r_k, q_k, r_{k+1})`` (the reference flattens to
``(tables, p, r*q*r')``; same math, different static layout).  A copy of
``falcon_ttdforgnns_tpu/ops/tt_init.py``: the same seed gives bit-identical
cores in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .tt_shapes import TTShapes


def _rng(seed: Optional[int]) -> np.random.Generator:
    return np.random.default_rng(seed)


def init_tt_cores(
    shapes: TTShapes,
    weight_dist: str = "normal",
    seed: Optional[int] = None,
) -> List[np.ndarray]:
    """Random init in one of the reference's five distributions."""
    rng = _rng(seed)
    T = shapes.ndim
    cores: List[np.ndarray] = []

    if weight_dist == "uniform":
        # Glorot-style variance split across cores, corrected for ranks.
        lamb = 2.0 / (shapes.num_embeddings + shapes.embedding_dim)
        stddev = np.sqrt(lamb)
        var = float(np.prod(np.array(shapes.ranks, dtype=np.float64) ** (-1.0 / (2 * T))))
        core_stddev = stddev ** (1.0 / T) * var
        for k in range(T):
            cores.append(rng.uniform(0.0, core_stddev, size=shapes.core_shape(k)).astype(np.float32))
    elif weight_dist == "naive-uniform":
        hi = 1.0 / np.sqrt(shapes.num_embeddings)
        for k in range(T):
            cores.append(rng.uniform(0.0, hi, size=shapes.core_shape(k)).astype(np.float32))
    elif weight_dist == "normal":
        sigma = 1.0 / np.sqrt(shapes.num_embeddings)
        scale = 1.0 / shapes.ranks[0]
        for k in range(T):
            cores.append((rng.normal(0.0, sigma, size=shapes.core_shape(k)) * scale).astype(np.float32))
    elif weight_dist == "approx-normal":
        # Truncated-away-from-zero normal so the 3-way product of core
        # entries approximates N(0, 1/N): resample |w| < 2.
        scale = float(np.power(1.0 / np.sqrt(3 * shapes.num_embeddings), 1.0 / 3.0))
        for k in range(T):
            shp = shapes.core_shape(k)
            w = rng.normal(0.0, 1.0, size=shp)
            small = np.abs(w) < 2
            while small.any():
                w[small] = rng.normal(0.0, 1.0, size=int(small.sum()))
                small = np.abs(w) < 2
            cores.append((w * scale).astype(np.float32))
    elif weight_dist == "approx-uniform":
        cores = _approx_uniform(shapes, rng)
    else:
        raise ValueError(f"unknown weight_dist {weight_dist!r}")
    return cores


def _flat_saw_tooth(rng, nb_gridpts: int, width: float, nb_samples: int) -> np.ndarray:
    """Sum of a uniform lattice offset and a narrow uniform: convolving with a
    narrow bump yields an approximately uniform marginal."""
    delta = 1.0 / nb_gridpts
    j = rng.integers(-(nb_gridpts - 1), nb_gridpts, size=nb_samples)
    x = -width / 2.0 + width * rng.random(nb_samples)
    return j * delta + x


def _approx_uniform(shapes: TTShapes, rng, sigma: float = 0.01,
                    nb_gridpts: int = 15, width: float = 0.7 / 30.0) -> List[np.ndarray]:
    """Saw-tooth scheme: the 3-core chain product of rows approximates a
    uniform distribution (`FBTT/tt_embeddings_ops.py:678-808`)."""
    if shapes.ndim != 3:
        raise ValueError("approx-uniform requires exactly 3 TT cores")
    (p0, _, q0, r1), (p1, _, q1, r2), (p2, _, q2, _) = shapes.core_shapes
    scale = float(1.0 / (np.sqrt(shapes.num_embeddings) ** (1.0 / 3.0)))

    # head (1, p0*q0, r1): gaussian around 1/sqrt(r1)
    head = (1.0 / np.sqrt(r1)) + rng.normal(0.0, sigma, size=(1, p0, q0, r1))
    # mid (r1, p1*q1, r2): gaussian around 1/sqrt(r1); for each (m,n) one even
    # slot in r2 is zeroed except one saw-tooth entry.
    mid_scale = 1.0 / np.sqrt(r1)
    mid = mid_scale + rng.normal(0.0, sigma, size=(r1, p1 * q1, r2))
    values = _flat_saw_tooth(rng, nb_gridpts, width, p1 * q1) / mid_scale
    for ell in range(p1 * q1):
        p = int(rng.integers(0, max(1, r2 // 2))) * 2 % r2
        mid[:, ell, p] = rng.normal(size=r1) * (sigma * sigma / mid_scale)
        j = int(rng.integers(0, r1))
        mid[j, ell, p] = values[ell]
    # tail (r2, p2*q2, 1): small gaussian background, one odd slot per (m,n)
    # drawn from the saw-tooth.
    tail = rng.normal(0.0, sigma, size=(r2, p2 * q2))
    values = _flat_saw_tooth(rng, nb_gridpts, width, p2 * q2)
    for ell in range(p2 * q2):
        p = (int(rng.integers(0, max(1, r2 // 2))) * 2 + 1) % r2
        tail[p, ell] = values[ell]
    tail = tail.reshape(r2, p2, q2, 1)

    cores = [head * scale, mid.reshape(r1, p1, q1, r2) * scale, tail * scale]
    # (r, p, q, r') -> (p, r, q, r')
    return [np.ascontiguousarray(c.transpose(1, 0, 2, 3)).astype(np.float32) for c in cores]


def init_ortho(shapes: TTShapes, seed: Optional[int] = None) -> List[np.ndarray]:
    """Random-orthogonal init: rows of random orthogonal matrices, normalized,
    reshaped into core slices (`tt_utils.py:117-155`)."""
    rng = _rng(seed)
    T = shapes.ndim
    cores = []
    for k in range(T):
        p, r, q, rn = shapes.core_shape(k)
        n_slices = r * q  # one orthonormal row per (r, q) slice
        dim = p * rn
        m = rng.normal(size=(max(n_slices, dim), dim)).astype(np.float32)
        qmat, _ = np.linalg.qr(m)
        core = np.zeros((p, r, q, rn), dtype=np.float32)
        i = 0
        for ri in range(r):
            for qi in range(q):
                row = qmat[i % qmat.shape[0], :dim]
                row = row / np.linalg.norm(row)
                core[:, ri, qi, :] = row.reshape(p, rn)
                i += 1
        cores.append(core)
    return cores


def tt_svd(shapes: TTShapes, matrix: np.ndarray) -> List[np.ndarray]:
    """TT-SVD of a full (N, D) matrix into cores of the given shapes
    (`tt_utils.py:157-201`).  Rows beyond N (when prod(p) > N) are
    zero-padded before decomposition.
    """
    N, D = matrix.shape
    P = int(np.prod(shapes.p_shapes))
    if N < P:
        matrix = np.concatenate([matrix, np.zeros((P - N, D), dtype=matrix.dtype)], axis=0)
    T = shapes.ndim
    # (p0..pT-1, q0..qT-1) -> interleave -> (p0*q0, p1*q1, ...)
    tensor = matrix.reshape(*shapes.p_shapes, *shapes.q_shapes)
    perm = []
    for k in range(T):
        perm += [k, T + k]
    tensor = tensor.transpose(perm).reshape([p * q for p, q in zip(shapes.p_shapes, shapes.q_shapes)])

    cores = []
    ranks = [1]
    temp = tensor
    for k in range(T - 1):
        rows = ranks[k] * tensor.shape[k]
        temp = temp.reshape(rows, -1)
        rk = min(shapes.ranks[k], rows, temp.shape[1])
        u, s, vh = np.linalg.svd(temp, full_matrices=False)
        u, s, vh = u[:, :rk], s[:rk], vh[:rk]
        core = u.reshape(ranks[k], shapes.p_shapes[k], shapes.q_shapes[k], rk)
        cores.append(np.ascontiguousarray(core.transpose(1, 0, 2, 3)).astype(np.float32))
        temp = (np.diag(s) @ vh)
        ranks.append(rk)
    last = temp.reshape(ranks[-1], shapes.p_shapes[-1], shapes.q_shapes[-1], 1)
    cores.append(np.ascontiguousarray(last.transpose(1, 0, 2, 3)).astype(np.float32))

    # pad ranks up to the requested shapes if SVD truncated below them
    out = []
    for k, c in enumerate(cores):
        p, r, q, rn = shapes.core_shape(k)
        buf = np.zeros((p, r, q, rn), dtype=np.float32)
        buf[:, : c.shape[1], :, : c.shape[3]] = c
        out.append(buf)
    return out


def spectral_matrix(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_nodes: int,
    k: int,
    mode: str = "adj",
) -> np.ndarray:
    """k leading eigenvectors of the adjacency (or Laplacian) as an (N, k)
    spectral feature matrix (`tt_utils.py:102-115` ``get_eigen``)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    data = np.ones(indices.shape[0], dtype=np.float32)
    adj = sp.csr_matrix((data, indices, indptr), shape=(num_nodes, num_nodes))
    if mode == "laplacian":
        deg = np.asarray(adj.sum(axis=1)).ravel()
        adj = sp.diags(deg) - adj
    vals, vecs = spla.eigs(adj.astype(np.float32), k=k, tol=1e-5, ncv=min(num_nodes, k * 3))
    return np.real(vecs).astype(np.float32)


def init_eigen(shapes: TTShapes, indptr, indices, seed=None, mode: str = "adj") -> List[np.ndarray]:
    """Spectral init: TT-SVD of the graph's leading eigenvector matrix
    (the reference's ``init=eigen`` scheme, `gnn_model.py:129-160`)."""
    mat = spectral_matrix(indptr, indices, shapes.num_embeddings, shapes.embedding_dim, mode)
    return tt_svd(shapes, mat)


def init_dortho(shapes: TTShapes, seed: Optional[int] = None) -> List[np.ndarray]:
    """Decomposed-orthogonal: TT-SVD of a random orthonormal (N, D) matrix
    (the reference's ``init=dortho``, `gnn_model.py:161-178`)."""
    rng = _rng(seed)
    P = int(np.prod(shapes.p_shapes))
    m = rng.normal(size=(P, shapes.embedding_dim)).astype(np.float32)
    q, _ = np.linalg.qr(m)
    return tt_svd(shapes, q[:, : shapes.embedding_dim])

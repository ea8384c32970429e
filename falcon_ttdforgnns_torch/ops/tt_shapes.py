"""TT shape utilities: validation, factorization search, index digit decomposition.

Capability parity with the reference's shape machinery
(`FBTT/tt_embeddings_ops.py:369-429` ``suggested_tt_shapes``,
`FBTT/tt_embeddings_ops.py:488-527` shape validation + stride buffer ``L``,
`utils.py:53-131` factor-combination helpers).  Everything here is
host-side numpy/python and produces *static* metadata that the lookup ops
and the CUDA kernels' launch parameters are built from.  A copy of
``falcon_ttdforgnns_tpu/ops/tt_shapes.py``, kept here so the port never
imports the JAX package.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


def prime_factors(n: int) -> List[int]:
    """Prime factorization of ``n`` (ascending, with multiplicity)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    factors: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    return factors


def _multiset_partitions_k(items: List[int], k: int):
    """Yield all partitions of multiset ``items`` into exactly ``k``
    (possibly empty-product) groups, as tuples of group products.

    Enumerates per-distinct-item count compositions — Π_p C(c_p+k-1, k-1)
    combinations — instead of the naive k^n group assignments, which hangs
    for highly-composite sizes (2^20 nodes → 3^20 assignments)."""
    if k == 1:
        yield (int(np.prod(items)) if items else 1,)
        return
    from collections import Counter
    counts = sorted(Counter(items).items())

    def compositions(c: int, parts: int):
        if parts == 1:
            yield (c,)
            return
        for first in range(c + 1):
            for rest in compositions(c - first, parts - 1):
                yield (first,) + rest

    seen = set()

    def rec(i: int, prods: List[int]):
        if i == len(counts):
            key = tuple(prods)
            if key not in seen:
                seen.add(key)
                yield key
            return
        p, c = counts[i]
        for comp in compositions(c, k):
            yield from rec(i + 1, [pr * p ** ci for pr, ci in zip(prods, comp)])

    yield from rec(0, [1] * k)


def factor_combinations(n: int, d: int) -> List[Tuple[int, ...]]:
    """All ways to write ``n`` as an *ordered* product of ``d`` positive
    integers (parity with `utils.py:63-95` ``factor_combinations_permute``)."""
    primes = prime_factors(n)
    out = set()
    for combo in _multiset_partitions_k(primes, d):
        for perm in itertools.permutations(combo):
            out.add(perm)
    return sorted(out)


def _entropy(xs: Sequence[int]) -> float:
    p = np.asarray(xs, dtype=np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def suggested_tt_shapes(n: int, d: int = 3, allow_round_up: bool = True) -> List[int]:
    """Factorize ``n`` into ``d`` factors whose product covers ``n``,
    maximizing the entropy of the factor distribution (i.e. prefer balanced
    factors).  Parity with `FBTT/tt_embeddings_ops.py:369-429`.

    If ``n`` has no balanced exact factorization and ``allow_round_up``,
    search ``n..n*2`` for the first integer admitting a d-way factorization
    with all factors > 1 and return the most balanced one.
    """
    if d == 1:
        return [n]

    def best_for(m: int):
        combos = [c for c in _multiset_partitions_k(prime_factors(m), d) if all(f > 1 for f in c)]
        if not combos:
            return None
        best = max(combos, key=_entropy)
        return sorted(best, reverse=True)

    if not allow_round_up:
        res = best_for(n)
        if res is None:
            raise ValueError(f"{n} admits no {d}-way factorization with factors > 1")
        return res

    for m in range(n, 2 * n + 1):
        res = best_for(m)
        if res is not None:
            return res
    raise ValueError(f"no suitable factorization found for {n}")  # pragma: no cover


@dataclass(frozen=True)
class TTShapes:
    """Static TT-decomposition metadata.

    num_embeddings N <= prod(p_shapes); embedding_dim D == prod(q_shapes);
    ranks has length T-1 (boundary ranks are implicitly 1).
    Mirrors the validation at `FBTT/tt_embeddings_ops.py:488-527`.
    """

    num_embeddings: int
    embedding_dim: int
    p_shapes: Tuple[int, ...]
    q_shapes: Tuple[int, ...]
    ranks: Tuple[int, ...]

    def __post_init__(self):
        T = len(self.p_shapes)
        if not (2 <= T <= 4):
            raise ValueError(f"need 2..4 TT cores, got {T}")
        if len(self.q_shapes) != T:
            raise ValueError("p_shapes and q_shapes must have equal length")
        if len(self.ranks) != T - 1:
            raise ValueError(f"need {T - 1} ranks for {T} cores, got {len(self.ranks)}")
        if int(np.prod(self.p_shapes)) < self.num_embeddings:
            raise ValueError(
                f"prod(p_shapes)={int(np.prod(self.p_shapes))} < num_embeddings={self.num_embeddings}"
            )
        if int(np.prod(self.q_shapes)) != self.embedding_dim:
            raise ValueError(
                f"prod(q_shapes)={int(np.prod(self.q_shapes))} != embedding_dim={self.embedding_dim}"
            )

    @property
    def ndim(self) -> int:
        return len(self.p_shapes)

    @property
    def full_ranks(self) -> Tuple[int, ...]:
        """(1, r_1, ..., r_{T-1}, 1)."""
        return (1,) + tuple(self.ranks) + (1,)

    @property
    def strides(self) -> Tuple[int, ...]:
        """Row-major strides over p_shapes: digit_k = (idx // stride_k) % p_k.

        Equivalent to the ``L`` buffer at `FBTT/tt_embeddings_ops.py:519-527`.
        """
        s = []
        acc = 1
        for p in reversed(self.p_shapes):
            s.append(acc)
            acc *= p
        return tuple(reversed(s))

    def core_shape(self, k: int) -> Tuple[int, int, int, int]:
        """Shape of core k: (p_k, r_k, q_k, r_{k+1})."""
        fr = self.full_ranks
        return (self.p_shapes[k], fr[k], self.q_shapes[k], fr[k + 1])

    @property
    def core_shapes(self) -> List[Tuple[int, int, int, int]]:
        return [self.core_shape(k) for k in range(self.ndim)]

    @property
    def num_tt_params(self) -> int:
        return int(sum(np.prod(s) for s in self.core_shapes))

    @property
    def compression_rate(self) -> float:
        """Dense-table entries / TT entries (parity `tt_utils.py:87-100`)."""
        return float(self.num_embeddings * self.embedding_dim) / float(self.num_tt_params)

    # group := leading T-1 digits (the Efficient_TT dedup key,
    # `Efficient_TT/efficient_tt_cuda.cu:167`): group = idx // p_last.
    @property
    def p_last(self) -> int:
        return self.p_shapes[-1]

    @property
    def num_groups(self) -> int:
        return int(np.prod(self.p_shapes[:-1]))


def make_tt_shapes(
    num_embeddings: int,
    embedding_dim: int,
    ranks: Sequence[int] = (16, 16),
    p_shapes: Sequence[int] | None = None,
    q_shapes: Sequence[int] | None = None,
) -> TTShapes:
    """Build TTShapes, auto-suggesting p/q factorizations when absent."""
    d = len(ranks) + 1
    if p_shapes is None:
        p_shapes = suggested_tt_shapes(num_embeddings, d)
    if q_shapes is None:
        q_shapes = suggested_tt_shapes(embedding_dim, d, allow_round_up=False)
    return TTShapes(
        num_embeddings=num_embeddings,
        embedding_dim=embedding_dim,
        p_shapes=tuple(int(p) for p in p_shapes),
        q_shapes=tuple(int(q) for q in q_shapes),
        ranks=tuple(int(r) for r in ranks),
    )

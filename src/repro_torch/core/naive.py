"""Pure-Python VAT — the paper's baseline implementation.

The port of ``repro/core/naive.py``, unchanged: a faithful transcription
of the "standard Python VAT" the paper benchmarks against (Table 1) —
nested-loop pairwise distances and a list-based Prim reordering.
Deliberately unvectorized and framework-free: it is the correctness
oracle the certification harness (``numerics/certify.py``) scores every
fitted ordering against.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def pairwise_distances_naive(X: Sequence[Sequence[float]]) -> List[List[float]]:
    """O(n^2 d) nested-loop Euclidean distance matrix (pure Python)."""
    n = len(X)
    d = len(X[0])
    R = [[0.0] * n for _ in range(n)]
    for i in range(n):
        xi = X[i]
        for j in range(i + 1, n):
            xj = X[j]
            s = 0.0
            for k in range(d):
                diff = xi[k] - xj[k]
                s += diff * diff
            dist = math.sqrt(s)
            R[i][j] = dist
            R[j][i] = dist
    return R


def vat_order_naive(R: Sequence[Sequence[float]]) -> List[int]:
    """Prim-based VAT reordering (Bezdek & Hathaway 2002), pure Python.

    Step 1: the first vertex is the row containing the global maximum of R.
    Step t: append the unselected vertex with minimum distance to the
    selected set (greedy MST growth).
    """
    n = len(R)
    # row of the global maximum
    best_i, best_val = 0, -1.0
    for i in range(n):
        for j in range(n):
            if R[i][j] > best_val:
                best_val = R[i][j]
                best_i = i
    order = [best_i]
    selected = [False] * n
    selected[best_i] = True
    # min distance from each vertex to the selected set
    mind = list(R[best_i])
    for _ in range(1, n):
        q, qval = -1, float("inf")
        for j in range(n):
            if not selected[j] and mind[j] < qval:
                qval = mind[j]
                q = j
        order.append(q)
        selected[q] = True
        rq = R[q]
        for j in range(n):
            if rq[j] < mind[j]:
                mind[j] = rq[j]
    return order


def vat_naive(X: Sequence[Sequence[float]]) -> Tuple[List[List[float]], List[int]]:
    """Full naive VAT: returns (reordered matrix R*, order)."""
    R = pairwise_distances_naive(X)
    order = vat_order_naive(R)
    n = len(R)
    Rstar = [[R[order[i]][order[j]] for j in range(n)] for i in range(n)]
    return Rstar, order


def ivat_naive(Rstar: Sequence[Sequence[float]]) -> List[List[float]]:
    """iVAT transform (Havens & Bezdek 2012 recurrence), pure Python.

    Operates on a VAT-ordered dissimilarity matrix; produces the
    graph-geodesic (max-min path) distance matrix with sharper blocks.
    """
    n = len(Rstar)
    Dp = [[0.0] * n for _ in range(n)]
    for r in range(1, n):
        # nearest previously-ordered vertex
        j, jval = 0, float("inf")
        for k in range(r):
            if Rstar[r][k] < jval:
                jval = Rstar[r][k]
                j = k
        for k in range(r):
            v = Rstar[r][j] if k == j else max(Rstar[r][j], Dp[j][k])
            Dp[r][k] = v
            Dp[k][r] = v
    return Dp

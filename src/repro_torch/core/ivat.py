"""iVAT — improved VAT via graph-geodesic (max-min path) distances.

Uses the Havens & Bezdek (2012) O(n^2) recurrence, which requires the
input to already be VAT-ordered.  ``kernels/ops.py::ivat_from_vat`` runs
it: the CUDA kernels (``kernels/csrc/ivat_update.cu``: the range route for
a Prim order, the serial recurrence otherwise) for a CUDA matrix, the
plain PyTorch loop (``kernels/ref.py``) for a CPU one; this module is the
stable public surface, as ``repro/core/ivat.py`` is.
"""
from __future__ import annotations

import torch

from repro_torch.core.vat import (VATResult, vat_batch_from_dist,
                                  vat_from_dist)
from repro_torch.kernels import ops as kops


def ivat_from_vat(rstar: torch.Tensor) -> torch.Tensor:
    """VAT-ordered dissimilarity matrix -> iVAT geodesic matrix.

    Args:
      rstar: (n, n) float32 — VAT-ordered dissimilarity matrix (the
        ``rstar`` field of a ``VATResult``), or a (b, n, n) stack of them
        (one call for the stack on the card). Must be VAT-ordered: the
        recurrence below is the geodesic only along a recorded Prim
        traversal.

    Returns:
      float32 of rstar's shape — D', the max-min path ("geodesic")
      distance matrix, symmetric with zero diagonal.

    The Havens & Bezdek (2012) recurrence: with D = R* VAT-ordered,
    D'[0, 0] = 0, and for each r = 1 .. n-1 in order,

        j        = argmin_{k < r} D[r, k]          (nearest ordered point —
                                                    the MST edge that
                                                    attached point r)
        D'[r, k] = max(D[r, j], D'[j, k])   for k < r, k != j
        D'[r, j] = D[r, j]
        D'[k, r] = D'[r, k]                 (symmetry), D'[r, r] = 0.

    Every path from r to an earlier point k must cross r's MST attachment
    edge (r, j), so the minimax path cost is that edge's weight capped
    below by the already-known minimax cost D'[j, k] — hence the single
    max per entry and the O(n^2) total.

    For any matrix the recurrence computes, with w_r = D[r, j_r], the
    largest w on the path between two points of the tree of edges
    (r, j_r), capped below by 0.  When no i with j_r < i < r has
    w_i > w_r, for every r — and every Prim order meets that — the path
    maximum is a range maximum, D'[a, c] = max(0, w_{a+1}, .., w_c) for
    a < c.  The card checks the condition a lane at a time and writes
    such lanes as range maxima on every SM; other lanes run the
    recurrence.  Both give the same values.
    """
    return kops.ivat_from_vat(rstar)


def ivat(R: torch.Tensor) -> tuple[torch.Tensor, VATResult]:
    """Dissimilarity matrix -> (iVAT image, underlying VAT result).

    Args:
      R: (n, n) float — symmetric dissimilarity matrix, zero diagonal.

    Returns:
      ((n, n) float32 geodesic image, VATResult of the ordering pass).
    """
    res = vat_from_dist(R)
    return ivat_from_vat(res.rstar), res


def ivat_batch(X: torch.Tensor, *, metric: str = "euclidean",
               form: str = "gram") -> tuple[torch.Tensor, VATResult]:
    """Batched iVAT: a stack of datasets -> a stack of geodesic images.

    Args:
      X: (b, n, d) float — raw data, unlike ``ivat``, which takes a matrix;
        for a (b, n, n) dissimilarity stack use ``ivat_batch_from_dist``.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      ((b, n, n) float32 iVAT stack, batched VATResult).  Lane z equals
      ``ivat(kernels.ops.pairwise_dist(X[z]))`` bit for bit.
    """
    R = kops.pairwise_dist_batch(X, metric=metric, form=form)
    return ivat_batch_from_dist(R)


def ivat_batch_from_dist(R: torch.Tensor) -> tuple[torch.Tensor, VATResult]:
    """Batched ``ivat``: a precomputed (b, n, n) dissimilarity stack in."""
    res = vat_batch_from_dist(R)
    return ivat_from_vat(res.rstar), res


def ivat_batch_from_vat(rstar: torch.Tensor) -> torch.Tensor:
    """Geodesic transform of an already VAT-ordered (b, n, n) stack."""
    return ivat_from_vat(rstar)

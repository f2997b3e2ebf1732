"""VAT — Visual Assessment of Cluster Tendency, on PyTorch tensors.

The three stages of the paper, as in ``repro/core/vat.py``:

  1. pairwise dissimilarity  -> ``kernels.ops.pairwise_dist`` (the CUDA
                                tile kernel on the card)
  2. Prim MST reordering     -> ``vat_order``: a Python loop over device
                                tensors, one masked-argmin kernel per step
  3. matrix reordering       -> two gathers, ``reorder``

Everything stays on the input's device.  The Prim loop never reads a value
back to the host: the selected vertex is a 0-d device tensor, rows are
taken with ``index_select``, so n - 1 steps enqueue without a sync.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ops as kops


class VATResult(NamedTuple):
    rstar: torch.Tensor   # (n, n) reordered dissimilarity matrix
    order: torch.Tensor   # (n,) int64 permutation
    dist: torch.Tensor    # (n, n) original dissimilarity matrix


def vat_order(R: torch.Tensor, *,
              argmin: Callable | None = None) -> torch.Tensor:
    """Prim-based VAT ordering of a dissimilarity matrix.

    Args:
      R: (n, n) float — symmetric dissimilarity matrix, zero diagonal.
      argmin: the masked argmin each step calls — ``(vals, mask) ->
        (min, index)`` as 0-d tensors; None means ``kernels.ops.
        masked_argmin`` (the CUDA kernel for a CUDA matrix).  A check can
        pass ``kernels.ref.masked_argmin_ref`` to run the plain version on
        the same matrix.

    Returns:
      (n,) int64 permutation — the VAT visit order: the first vertex is the
      row of the global maximum (``torch.argmax`` of the row maxima; the
      first index wins, and every row of a symmetric matrix has a partner
      row with the same maximum, so this tie rule always decides the
      seed), then greedy min-edge growth with first-index tie-breaking.
    """
    argmin = kops.masked_argmin if argmin is None else argmin
    n = R.shape[0]
    i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
    order = torch.empty(n, dtype=torch.int64, device=R.device)
    order[0] = i0[0]
    selected = torch.zeros(n, dtype=torch.bool, device=R.device)
    selected.index_fill_(0, i0, True)
    mind = R.index_select(0, i0)[0].clone()
    for t in range(1, n):
        _, q = argmin(mind, selected)
        q = q.view(1)
        order[t] = q[0]
        selected.index_fill_(0, q, True)
        torch.minimum(mind, R.index_select(0, q)[0], out=mind)
    return order


def reorder(R: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """R* = R[order][:, order] — one gather along each axis."""
    return R.index_select(0, order).index_select(1, order)


def vat(X: torch.Tensor, *, metric: str = "euclidean",
        form: str = "gram") -> VATResult:
    """Full VAT on a data matrix.

    Args:
      X: (n, d) float32 (or bfloat16 storage) — data points, on the device
        the fit runs on.
      metric: dissimilarity metric, one of ``kernels.ref.METRICS``.
        For an already-computed matrix use ``vat_from_dist`` instead.
      form: "gram" (default) or "direct" — the numerics-policy tile form
        (resolved host-side by ``numerics.resolve``).

    Returns:
      VATResult — rstar (n, n) reordered image, order (n,) int64
      permutation, dist (n, n) original dissimilarities.
    """
    R = kops.pairwise_dist(X, metric=metric, form=form)
    return vat_from_dist(R)


def vat_from_dist(R: torch.Tensor) -> VATResult:
    """VAT when the dissimilarity matrix is precomputed (paper step 2+3).

    Returns:
      VATResult with ``dist`` aliasing the input R.
    """
    order = vat_order(R)
    return VATResult(rstar=reorder(R, order), order=order, dist=R)


def block_structure_score(rstar: torch.Tensor,
                          threshold: float | None = None):
    """Quantify diagonal block structure of a VAT image.

    Args:
      rstar: (n, n) float — VAT-reordered dissimilarity matrix.
      threshold: cut threshold as a fraction of the matrix mean; None
        derives one from the super-diagonal statistics (mean + 2 std,
        floored at half the largest jump).

    Returns:
      (score, k_est) as 0-d tensors: ``score`` in [0, 1] — mean
      off-diagonal-band contrast; ``k_est`` — estimated number of diagonal
      blocks by counting super-diagonal "cuts" (adjacent-in-order
      distances above threshold).
    """
    sup = torch.diagonal(rstar, offset=1)          # adjacent-in-order dists
    scale = torch.mean(rstar) + 1e-12
    if threshold is None:
        # a "cut" must stand out both locally (vs typical adjacent dist)
        # and globally (a sizeable fraction of the largest jump)
        thr = torch.maximum(
            torch.mean(sup) + 2.0 * torch.std(sup, correction=0),
            0.5 * torch.max(sup))
    else:
        thr = threshold * scale
    cuts = torch.sum(sup > thr)
    k_est = cuts + 1
    # contrast: how much darker the near-diagonal band is vs global mean
    band = torch.mean(sup)
    score = torch.clamp(1.0 - band / scale, 0.0, 1.0)
    return score, k_est

"""Plain PyTorch versions of the port's kernels.

Written straight from ``repro/kernels/ref.py``: the same formulas, on
tensors.  ``kernels/ops.py`` takes them for CPU tensors; ``chip_smoke.py``
holds each CUDA kernel against them on the card.  A CUDA tensor on the
library's main path never comes here.

Metric support: VAT is defined on an arbitrary pairwise *dissimilarity*
matrix, so the distance versions are metric-dispatched.  ``METRICS`` is the
tuple of computable metrics; ``"precomputed"`` (the caller hands the
matrix in) is an API-layer concept and never reaches this module.
"""
from __future__ import annotations

import torch

from repro_torch.numerics.condition import check_form

#: Metrics every pairwise path (plain version and CUDA tile) implements.
METRICS = ("euclidean", "sqeuclidean", "manhattan", "cosine")


def check_metric(metric: str):
    """Raise ValueError unless ``metric`` names a computable metric."""
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")


def pairwise_dissim_ref(X: torch.Tensor, Y: torch.Tensor | None = None, *,
                        metric: str = "euclidean",
                        form: str = "gram") -> torch.Tensor:
    """Metric-dispatched pairwise dissimilarity matrix.

    Args:
      X: (n, d) float — query points.
      Y: (m, d) float or None — reference points (None: Y = X).
      metric: one of ``METRICS``.
        euclidean    ||xi - yj||_2          (Gram form: one matmul)
        sqeuclidean  ||xi - yj||_2^2        (same, no sqrt)
        manhattan    sum_k |xik - yjk|      (broadcast |diff| reduce)
        cosine       1 - xi.yj/(|xi||yj|)   (in [0, 2]; zero-norm rows
                                             get an eps-guarded denom)
      form: "gram" (default; absolute cancellation error ~eps·max||x||²)
        or "direct" — ``sum_k (xik - yjk)²``, no cancellation.  Only
        meaningful for euclidean/sqeuclidean.

    Returns:
      (n, m) float32 dissimilarity matrix.
    """
    check_metric(metric)
    check_form(form)
    if Y is None:
        Y = X
    Xf = X.float()
    Yf = Y.float()
    if metric in ("euclidean", "sqeuclidean"):
        if form == "direct":
            diff = Xf[:, None, :] - Yf[None, :, :]
            sq = torch.sum(diff * diff, dim=-1)
        else:
            nx = torch.sum(Xf * Xf, dim=-1)
            ny = torch.sum(Yf * Yf, dim=-1)
            sq = torch.clamp_min(
                nx[:, None] + ny[None, :] - 2.0 * (Xf @ Yf.T), 0.0)
        return torch.sqrt(sq) if metric == "euclidean" else sq
    if metric == "manhattan":
        return torch.sum(torch.abs(Xf[:, None, :] - Yf[None, :, :]), dim=-1)
    # cosine
    cross = Xf @ Yf.T
    nx = torch.sqrt(torch.sum(Xf * Xf, dim=-1))
    ny = torch.sqrt(torch.sum(Yf * Yf, dim=-1))
    denom = torch.clamp_min(nx[:, None] * ny[None, :], 1e-12)
    return torch.clamp(1.0 - cross / denom, 0.0, 2.0)


def masked_argmin_ref(vals: torch.Tensor, mask: torch.Tensor):
    """(min value, argmin index) of vals where mask is False.

    Args:
      vals: (n,) float — candidate values (Prim frontier distances).
      mask: (n,) bool — True means "excluded" (already selected).

    Returns:
      (min value: f32 0-d tensor, argmin index: int64 0-d tensor) over
      unmasked lanes, first-index tie-breaking (``torch.argmin`` returns
      the first minimal index); a fully masked vector gives (+inf, 0).
    """
    masked = torch.where(mask, torch.inf, vals.float())
    idx = torch.argmin(masked)
    return masked[idx], idx


def ivat_from_vat_ref(rstar: torch.Tensor) -> torch.Tensor:
    """iVAT geodesic transform of a VAT-ordered (n, n) matrix.

    Args:
      rstar: (n, n) float — VAT-ordered dissimilarity matrix.

    Returns:
      (n, n) float32 — max-min path distance matrix D' (Havens & Bezdek
      2012 recurrence; see ``core.ivat.ivat_from_vat`` for the math).
      Each step is a vectorized O(n) row update; the row index stays a
      device tensor, so no step waits on the host.
    """
    n = rstar.shape[0]
    R = rstar.float()
    Dp = torch.zeros_like(R)
    idx = torch.arange(n, device=R.device)
    for r in range(1, n):
        row = R[r]
        mask = idx < r
        j = torch.argmin(torch.where(mask, row, torch.inf)).view(1)
        # D'[r,k] = max(R*[r,j], D'[j,k]) for k<r; at k=j, D'[j,j]=0 gives R*[r,j]
        newrow = torch.where(
            mask, torch.maximum(row.index_select(0, j), Dp.index_select(0, j)[0]),
            0.0)
        Dp[r, :] = newrow
        Dp[:, r] = newrow
    return Dp

"""sVAT — scalable VAT via maximin (k-centroid) sampling, on PyTorch.

As in ``repro/core/svat.py``: pick s "distinguished" points by greedy
maximin (farthest-point) sampling, which keeps the global cluster geometry,
then run exact VAT on the sample — O(n s + s^2) in place of O(n^2).  The
random start comes from a ``torch.Generator`` (the reference's key); the
``*_from`` forms take the start index itself, so two packages can be fed
the same start.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.vat import VATResult, vat_from_dist
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import row_dissim_ref, take


class SVATResult(NamedTuple):
    vat: VATResult
    sample_idx: torch.Tensor  # (s,) int64 indices of the distinguished points


def maximin_sample_from(X: torch.Tensor, s: int, i0, *,
                        metric: str = "euclidean") -> torch.Tensor:
    """Greedy farthest-point sampling from the start index i0.

    Args:
      X: (n, d) float — data points.
      s: number of points to pick.
      i0: the first pick (int or integer tensor on X's device).
      metric: the dissimilarity of the frontier updates
        (``kernels.ref.row_dissim_ref``), one of ``kernels.ref.METRICS``.

    Returns:
      (s,) int64 indices into X; each pick maximizes the dissimilarity to
      the picks before it (the first index among equals).  O(n s) time,
      O(n) memory, no host sync.
    """
    idx = torch.empty(s, dtype=torch.int64, device=X.device)
    idx[0] = torch.as_tensor(i0, device=X.device)
    mind = row_dissim_ref(X, take(X, idx[0]), metric=metric)
    for t in range(1, s):
        q = torch.argmax(mind)
        idx[t] = q
        mind = torch.minimum(mind, row_dissim_ref(X, take(X, q),
                                                  metric=metric))
    return idx


def maximin_sample(X: torch.Tensor, s: int, generator: torch.Generator, *,
                   metric: str = "euclidean") -> torch.Tensor:
    """``maximin_sample_from`` a start drawn uniformly from the n rows with
    ``generator`` (on X's device)."""
    i0 = torch.randint(0, X.shape[0], (), generator=generator,
                       device=X.device)
    return maximin_sample_from(X, s, i0, metric=metric)


def svat_from(X: torch.Tensor, i0, *, s: int = 256,
              metric: str = "euclidean") -> SVATResult:
    """sVAT from the maximin start i0: the exact VAT of the s sampled
    points, their (s, s) matrix from ``kernels.ops.pairwise_dist`` (the
    CUDA kernel on the card).

    Args:
      X: (n, d) float — data points.
      i0: the first maximin pick.
      s: sample size (clamped to n).
      metric: one of ``kernels.ref.METRICS``, for the sampling and the
        image alike.

    Returns:
      SVATResult — ``vat`` the VATResult of the sample, ``sample_idx`` the
      (s,) dataset rows of the sampled points.
    """
    s = min(s, X.shape[0])
    idx = maximin_sample_from(X, s, i0, metric=metric)
    R = kops.pairwise_dist(X.index_select(0, idx), metric=metric)
    return SVATResult(vat=vat_from_dist(R), sample_idx=idx)


def svat(X: torch.Tensor, generator: torch.Generator, *, s: int = 256,
         metric: str = "euclidean") -> SVATResult:
    """Approximate VAT image of X from s maximin-sampled points: ``svat_from``
    a start drawn with ``generator`` (on X's device)."""
    i0 = torch.randint(0, X.shape[0], (), generator=generator,
                       device=X.device)
    return svat_from(X, i0, s=s, metric=metric)

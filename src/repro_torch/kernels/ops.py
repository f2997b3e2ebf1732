"""Public wrappers of the kernels package: the device decides the path.

A CUDA tensor launches the hand-written CUDA kernel (``pairwise_dist.py``,
``prim_update.py``, ``ivat_update.py``); a CPU tensor takes the plain
PyTorch version in ``ref.py``.  There is no other switch and no fallback: a
CUDA tensor the kernel refuses raises.  ``launch_counts()`` reads how often
each kernel was launched since ``reset_launch_counts()``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.ivat_update import ivat_from_vat_cuda
from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
from repro_torch.kernels.prim_update import masked_argmin_cuda

__all__ = ["pairwise_dist", "masked_argmin", "ivat_from_vat",
           "launch_counts", "reset_launch_counts"]


def _dispatch_site(op: str, device: torch.device) -> None:
    """The ``kernels.dispatch`` fault-injection site, a no-op until the
    port has its fault registry (the reference's ``repro.faults``)."""


def pairwise_dist(X: torch.Tensor, Y: torch.Tensor | None = None, *,
                  metric: str = "euclidean",
                  form: str = "gram") -> torch.Tensor:
    """Pairwise dissimilarity matrix; CUDA kernel on the card.

    Args:
      X: (n, d) float — query points.
      Y: (m, d) float or None — reference points; None means self-
        dissimilarities (and forces an exactly-zero diagonal).
      metric: one of ``ref.METRICS``.
      form: "gram" (default) or "direct" — the numerics-policy tile form.

    Returns:
      (n, m) float32 dissimilarity matrix ((n, n) when Y is None).
    """
    _dispatch_site("pairwise_dist", X.device)
    if X.is_cuda:
        R = pairwise_dist_cuda(X, Y, metric=metric, form=form)
    else:
        R = ref.pairwise_dissim_ref(X, Y, metric=metric, form=form)
    if Y is None:  # exact zero diagonal for self-dissimilarities
        R.fill_diagonal_(0.0)
    return R


def masked_argmin(vals: torch.Tensor, mask: torch.Tensor):
    """(min, argmin) over unmasked entries (mask=True excludes).

    Returns:
      (f32 0-d tensor, int64 0-d tensor) on vals' device, first-index
      tie-breaking.
    """
    _dispatch_site("masked_argmin", vals.device)
    if vals.is_cuda:
        return masked_argmin_cuda(vals, mask)
    return ref.masked_argmin_ref(vals, mask)


def ivat_from_vat(rstar: torch.Tensor) -> torch.Tensor:
    """iVAT geodesic transform of VAT-ordered dissimilarities.

    Args:
      rstar: (n, n) or (b, n, n) float — VAT-ordered matrix/stack.

    Returns:
      float32 max-min path distance matrix/stack of the same shape.
    """
    _dispatch_site("ivat_from_vat", rstar.device)
    if rstar.is_cuda:
        return ivat_from_vat_cuda(rstar)
    if rstar.dim() == 3:
        return torch.stack([ref.ivat_from_vat_ref(R) for R in rstar])
    return ref.ivat_from_vat_ref(rstar)

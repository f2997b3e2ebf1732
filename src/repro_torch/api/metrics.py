"""Metric names and validation for the public API.

VAT is defined on an arbitrary pairwise dissimilarity matrix; the facade
therefore accepts a ``metric=`` that is either one of the *computable*
metrics (threaded down to ``kernels/ops.py``) or
``"precomputed"``, in which case ``fit(D)`` takes the (n, n) matrix
directly and no distance kernel runs.

>>> from repro_torch.api.metrics import METRICS, COMPUTED_METRICS
>>> "precomputed" in METRICS and "precomputed" not in COMPUTED_METRICS
True
>>> from repro_torch.api.metrics import validate_metric
>>> validate_metric("cosine")
>>> validate_metric("hamming")   # doctest: +ELLIPSIS
Traceback (most recent call last):
    ...
ValueError: metric must be one of ...
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.ref import METRICS as COMPUTED_METRICS

PRECOMPUTED = "precomputed"

#: Everything ``FastVAT(metric=...)`` accepts.
METRICS = COMPUTED_METRICS + (PRECOMPUTED,)


def validate_metric(metric: str, *, allow_precomputed: bool = True):
    """Raise ValueError unless ``metric`` is an accepted name."""
    allowed = METRICS if allow_precomputed else COMPUTED_METRICS
    if metric not in allowed:
        raise ValueError(f"metric must be one of {allowed}, got {metric!r}")


def as_dissimilarity(D, *, batched: bool = False) -> np.ndarray:
    """Validate a user-supplied precomputed dissimilarity matrix.

    Args:
      D: (n, n) array-like — pairwise dissimilarities ((b, n, n) when
        ``batched``).
      batched: expect a leading batch axis.

    Returns:
      float32 numpy array of the validated matrix/stack.

    Raises:
      ValueError: wrong rank, non-square trailing axes, asymmetry beyond
        f32 tolerance, or a significantly non-zero diagonal — the VAT
        contract is a symmetric dissimilarity with zero self-distance.
    """
    D = np.asarray(D, np.float32)
    want = 3 if batched else 2
    shape_hint = "(b, n, n)" if batched else "(n, n)"
    if D.ndim != want or D.shape[-1] != D.shape[-2]:
        raise ValueError(
            f"metric='precomputed' expects a square {shape_hint} "
            f"dissimilarity matrix, got shape {D.shape}")
    scale = max(1.0, float(np.max(np.abs(D))) if D.size else 1.0)
    if not np.allclose(D, np.swapaxes(D, -1, -2), atol=1e-4 * scale):
        raise ValueError("precomputed dissimilarity matrix must be "
                         "symmetric (max |D - D.T| exceeds tolerance)")
    diag = np.diagonal(D, axis1=-2, axis2=-1)
    if D.size and float(np.max(np.abs(diag))) > 1e-4 * scale:
        raise ValueError("precomputed dissimilarity matrix must have a "
                         "zero diagonal (self-dissimilarity)")
    return D

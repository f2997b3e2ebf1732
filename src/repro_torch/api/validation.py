"""Input admission for the public fit surface, ported verbatim (numpy).

The kernels' min/argmin folds are silent on non-finite input — a single
NaN row propagates through the Prim frontier and produces a garbage
ordering with no error (the CUDA argmin's packed keys do not order NaN at
all).  Admission therefore happens at the edge (``FastVAT.fit``), before
a bad dataset can reach a kernel, and it fails with one typed error:

:class:`InvalidInput` subclasses ``ValueError``, so callers catching
``ValueError`` keep working.  The ``reason`` tags are the reference's.

Checks (all O(n·d), one vectorized pass — skippable via
``FastVAT(validate=False)`` for trusted hot loops):

  * dtype is real-numeric (bool/int/float; complex, strings and object
    arrays are rejected rather than silently cast),
  * every value is finite (no NaN / +-Inf),
  * n >= ``MIN_POINTS`` (a VAT ordering of fewer points is degenerate),
  * the points are not all identical (zero variance — every pairwise
    dissimilarity is 0 and the "ordering" is meaningless),
  * under ``metric="cosine"``: no zero-norm rows — the kernels' eps
    -guard silently maps them to distance 1.0 from everything, which
    is a fabricated geometry, not the caller's data.  Skipping
    validation (``validate=False``) keeps the documented eps-guard
    semantics for callers who want exactly that.
"""
from __future__ import annotations

import numpy as np

#: Smallest point count a tendency assessment is defined for.
MIN_POINTS = 4


class InvalidInput(ValueError):
    """A dataset was rejected at admission (never reached a kernel).
    ``reason`` is a stable machine-readable tag: "dtype" | "non_finite" |
    "too_few_points" | "degenerate" | "zero_norm"."""

    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(message)


def _as_real_array(X, name: str) -> np.ndarray:
    arr = np.asarray(X)
    if arr.dtype == object or arr.dtype.kind not in "bifu":
        raise InvalidInput(
            "dtype", f"{name} must be a real numeric array, got dtype "
            f"{arr.dtype}")
    return arr


def validate_points(X, *, batched: bool = False, name: str = "X",
                    metric: str | None = None) -> None:
    """Admission-check an (n, d) point matrix (or (b, n, d) stack).

    Args:
      X: the candidate points.
      batched: expect a (b, n, d) stack instead of (n, d).
      name: how to refer to X in error messages.
      metric: the metric the fit will run, when known — enables
        metric-specific checks (currently: cosine's zero-norm screen).

    Raises:
      InvalidInput: non-numeric dtype, non-finite values, n below
        ``MIN_POINTS``, an all-identical (zero-variance) dataset, or a
        zero-norm row under ``metric="cosine"``.  Batched input names
        the offending lane in the message.
    """
    arr = _as_real_array(X, name)
    want = 3 if batched else 2
    if arr.ndim != want:
        # shape errors stay plain ValueErrors at the callers; admission
        # only guards value-level poison.  Tolerate and let them handle.
        return
    n_axis = 1 if batched else 0
    n = arr.shape[n_axis]
    if n < MIN_POINTS:
        raise InvalidInput(
            "too_few_points",
            f"{name} has n={n} points; a tendency assessment needs at "
            f"least {MIN_POINTS}")
    if arr.dtype.kind == "f" and not bool(np.isfinite(arr).all()):
        if batched:
            bad = np.flatnonzero(
                ~np.isfinite(arr).all(axis=(1, 2)))
            where = f" (lane(s) {bad.tolist()})"
        else:
            where = ""
        raise InvalidInput(
            "non_finite",
            f"{name} contains non-finite values (NaN/Inf){where}; clean "
            "the data or pass validate=False to skip admission checks")
    spread = np.ptp(arr, axis=n_axis)
    if batched:
        dead = np.flatnonzero(~(spread.max(axis=-1) > 0))
        if dead.size:
            raise InvalidInput(
                "degenerate",
                f"{name} lane(s) {dead.tolist()} have zero variance "
                "(all points identical) — tendency is undefined")
    elif not bool(spread.max() > 0):
        raise InvalidInput(
            "degenerate",
            f"{name} has zero variance (all {n} points identical) — "
            "tendency is undefined")
    if metric == "cosine":
        norms = np.einsum("...nd,...nd->...n", np.asarray(arr, np.float64),
                          np.asarray(arr, np.float64))
        zero = norms == 0.0
        if bool(zero.any()):
            if batched:
                lanes = np.flatnonzero(zero.any(axis=-1))
                where = f" (lane(s) {lanes.tolist()})"
            else:
                where = f" (row(s) {np.flatnonzero(zero).tolist()})"
            raise InvalidInput(
                "zero_norm",
                f"{name} has zero-norm rows{where}; cosine dissimilarity "
                "is undefined for them (the kernels' eps-guard would "
                "silently map them to distance 1.0 from everything) — "
                "drop the rows or pass validate=False to keep the "
                "eps-guard semantics")


def validate_dissimilarity(D, *, name: str = "D") -> None:
    """Admission-check a precomputed dissimilarity (finite values only;
    shape/symmetry checks stay in ``metrics.as_dissimilarity``)."""
    arr = _as_real_array(D, name)
    if arr.dtype.kind == "f" and not bool(np.isfinite(arr).all()):
        raise InvalidInput(
            "non_finite",
            f"{name} contains non-finite dissimilarities (NaN/Inf); "
            "clean the matrix or pass validate=False")

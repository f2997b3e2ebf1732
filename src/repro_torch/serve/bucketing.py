"""Shape bucketing for the serving layer — pad-to-bucket without
perturbing the ordering; the reference's ``repro/serve/bucketing.py``.

Real-world traffic carries arbitrary (n, d) shapes; building one program
per exact shape would defeat the program cache.  This module
collapses the n axis onto power-of-2 buckets so a handful of programs
cover the whole shape distribution, and the batch axis onto power-of-2
lane counts so coalesced groups of any size reuse log2(max_batch)+1
programs per bucket.

Padding rows must not perturb the VAT ordering of the real points —
the served result has to be *bitwise* identical to the solo fit.  The
scheme that achieves this is **dup-row-0 padding**: rows n..bucket-1
of the padded matrix are copies of row 0.

Why dup-row-0 padding is exact (not just approximately harmless):

* Every padding point has a distance row identical to point 0's (its
  self-distance and its distance to the other dups are 0, matching
  point 0's diagonal entry).  While point 0 is unselected, a padding
  point's frontier value therefore equals point 0's at every Prim
  step.
* The kernels break ties by **first index** (``argmin``/``argmax``
  over a row pick the lowest index at equal value), and every padding
  index is >= n, so whenever a padding point is the frontier argmin a
  real point (point 0, or a lower-indexed real tie) wins instead —
  no padding point is ever selected before point 0.
* Padding points are NOT ordered after all real points: the moment
  point 0 enters the tree their frontier distance becomes
  ``d(X[0], X[0]) = 0``, so they ride in right after point 0 (real
  points at frontier 0 still win the tie).  That is harmless, because
  a duplicate of an already-selected point changes nothing: for every
  unselected point x, ``d(x, dup) = d(x, X[0])`` is already folded
  into x's frontier minimum, so no remaining frontier value — and no
  argmin tie-break among real points — moves.  The real-point
  subsequence of the padded ordering is therefore exactly the
  unpadded ordering, selected at the same frontier distances.
* The seed ``argmax(max(R, axis=1))`` cannot pick a padding row: its
  row maximum equals row 0's, and row 0 has the lower index.
* iVAT's path-max folds over duplicate rows are no-ops (folding a row
  with itself changes nothing), so the restricted geodesic image is
  unchanged too.

On the card an entry's bits depend only on its two points (every pair
is computed in one fixed order, symmetric in the pair), so a padding
row's distances are bitwise row 0's there too, even where the Gram form
leaves ``d(X[0], X[0])`` a tiny epsilon above 0 off the diagonal: the
padding points then ride in at that epsilon, after every real point
whose frontier is at or below it and before any whose frontier is above
it, so the first real point selected after them carries a weight above
the epsilon and every iVAT range maximum spanning them is a real weight.

tests/test_torch_serve.py pins all of this bitwise at bucket boundaries
+-1 for every metric, and chip_smoke.py's ``serve-pad`` phase on the
card.

``precomputed`` matrices cannot be padded this way — appending a
duplicate row to an (n, n) matrix does not yield an (n+1, n+1)
matrix — so :func:`ensure_bucketable` rejects the metric up front with
an actionable error instead of serving a silently wrong result.
"""
from __future__ import annotations

import numpy as np
import torch

#: Smallest n-bucket — shapes below this all share one program.
MIN_BUCKET = 64


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def bucket_n(n: int) -> int:
    """Smallest power-of-2 bucket >= max(n, MIN_BUCKET).

    Args:
      n: real number of points in the request.

    Returns:
      The padded row count the program will see.
    """
    if n < 1:
        raise ValueError(f"need at least one point, got n={n}")
    return _next_pow2(max(n, MIN_BUCKET))


def bucket_batch(b: int) -> int:
    """Smallest power-of-2 lane count >= b (>= 1)."""
    if b < 1:
        raise ValueError(f"need at least one request, got b={b}")
    return _next_pow2(b)


def ensure_bucketable(metric: str) -> None:
    """Reject metrics the padding scheme cannot serve.

    Raises:
      ValueError: for ``precomputed`` — a padded (n, n) matrix is not
        an (n_bucket, n_bucket) matrix; fit it directly via
        ``FastVAT.fit`` instead.
    """
    if metric == "precomputed":
        raise ValueError(
            "the serving layer cannot bucket metric='precomputed' "
            "(padding feature rows does not extend a distance matrix); "
            "use FastVAT(metric='precomputed').fit(D) directly")


def pad_rows(X: np.ndarray, n_bucket: int) -> np.ndarray:
    """Pad (n, d) -> (n_bucket, d) with copies of row 0 (see module
    docstring for why this is ordering-exact)."""
    n = X.shape[0]
    if n > n_bucket:
        raise ValueError(f"n={n} exceeds bucket {n_bucket}")
    if n == n_bucket:
        return X
    fill = np.broadcast_to(X[0], (n_bucket - n,) + X.shape[1:])
    return np.concatenate([X, fill], axis=0)


def pack_batch(Xs: list[np.ndarray], n_bucket: int,
               b_bucket: int) -> np.ndarray:
    """Stack requests into one (b_bucket, n_bucket, d) float32 block.

    Each dataset is row-padded to ``n_bucket``; empty lanes (when the
    group is smaller than ``b_bucket``) are copies of lane 0 — batched
    lanes are independent, so dup lanes cost compute but cannot perturb
    the real lanes' results.

    Args:
      Xs: the coalesced group's feature matrices, all with the same d.
      n_bucket: target row count (every ``len(X) <= n_bucket``).
      b_bucket: target lane count (``>= len(Xs)``).

    Returns:
      float32 array of shape (b_bucket, n_bucket, d).
    """
    if not Xs:
        raise ValueError("pack_batch needs at least one dataset")
    if b_bucket < len(Xs):
        raise ValueError(f"{len(Xs)} requests exceed lane bucket {b_bucket}")
    lanes = [pad_rows(np.asarray(X, dtype=np.float32), n_bucket)
             for X in Xs]
    lanes.extend(lanes[0] for _ in range(b_bucket - len(lanes)))
    return np.stack(lanes, axis=0)


def real_positions(order_pad, n: int):
    """Positions within the padded ordering that hold real points.

    Args:
      order_pad: the (n_bucket,) ordering from the padded fit — a host
        array, or a tensor (the result is then a tensor on its device).
      n: the real point count; indices < n are real.

    Returns:
      Increasing positions p with ``order_pad[p] < n`` — by the
      dup-row argument these select exactly the unpadded ordering.
    """
    if isinstance(order_pad, torch.Tensor):
        return torch.nonzero(order_pad < n).squeeze(1)
    return np.flatnonzero(np.asarray(order_pad) < n)


def restrict(M, pos):
    """Restrict a padded (n_bucket, n_bucket) image to the real
    positions on both axes — the unpadded image, bitwise.  A tensor is
    restricted on its device by index selection (no host copy)."""
    if isinstance(M, torch.Tensor):
        return M.index_select(0, pos).index_select(1, pos)
    M = np.asarray(M)
    return M[np.ix_(pos, pos)]

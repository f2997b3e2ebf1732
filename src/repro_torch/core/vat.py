"""VAT — Visual Assessment of Cluster Tendency, on PyTorch tensors.

The three stages of the paper, as in ``repro/core/vat.py``:

  1. pairwise dissimilarity  -> ``kernels.ops.pairwise_dist`` (the CUDA
                                tile kernel on the card)
  2. Prim MST reordering     -> ``vat_order``: ``kernels.ops.
                                vat_prim_order``, the whole traversal in
                                one launch on the card (the loop of masked
                                argmins on the CPU)
  3. matrix reordering       -> two gathers, ``reorder``

and the matrix-free (Flash-VAT) ordering of the ``flashvat`` rung,
``vat_matrix_free``: a streamed seed scan through the pairwise kernel, then
the whole Prim traversal without the (n, n) matrix — the persistent kernel
(``turbo=True``) or one fused step kernel per vertex (``turbo=False``).

Everything stays on the input's device, and no step of an ordering reads
a value back to the host.

The batched forms (``vat_batch``, ``vat_batch_from_dist``,
``vat_matrix_free_batch``) assess a (b, n, d) stack in the same number of
launches as one dataset: the lane is an axis of every kernel, never a
Python loop, except the flashvat seed scan, which runs per lane (about
17 ms a lane at n = 50,000 on an H100, beside a traversal of about
0.2 s a lane).  Each lane's result equals the single call on that lane bit
for bit, on either device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.prim_persist import DEFAULT_BLOCK
from repro_torch.kernels.ref import vat_prim_order_ref


class VATResult(NamedTuple):
    rstar: torch.Tensor   # (n, n) reordered dissimilarity matrix
    order: torch.Tensor   # (n,) int64 permutation
    dist: torch.Tensor    # (n, n) original dissimilarity matrix


class FlashVATResult(NamedTuple):
    order: torch.Tensor   # (n,) int64 exact VAT visit order
    edges: torch.Tensor   # (n,) f32 MST edge weight admitting each vertex


def vat_order(R: torch.Tensor, *,
              argmin: Callable | None = None) -> torch.Tensor:
    """Prim-based VAT ordering of a dissimilarity matrix.

    Args:
      R: (n, n) float32 — symmetric dissimilarity matrix, zero diagonal.
      argmin: None runs ``kernels.ops.vat_prim_order`` (one launch of the
        Prim kernel for a CUDA matrix).  A masked argmin ``(vals (1, n),
        mask) -> (min (1,), index (1,))`` instead runs the loop of
        ``kernels.ref.vat_prim_order_ref`` with it, one call a step: a
        check can pass ``kernels.ref.masked_argmin_ref`` to run the plain
        version on the same matrix.

    Returns:
      (n,) int64 permutation — the VAT visit order: the first vertex is the
      row of the global maximum (``torch.argmax`` of the row maxima; the
      first index wins, and every row of a symmetric matrix has a partner
      row with the same maximum, so this tie rule always decides the
      seed), then greedy min-edge growth with first-index tie-breaking.
    """
    i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
    if argmin is None:
        return kops.vat_prim_order(R, i0)
    return vat_prim_order_ref(R, i0, argmin=argmin)


def reorder(R: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """R* = R[order][:, order] — one gather along each axis."""
    return R.index_select(0, order).index_select(1, order)


def vat_order_batch(R: torch.Tensor) -> torch.Tensor:
    """``vat_order`` of every lane of a (b, n, n) stack: one launch of the
    Prim kernel for the whole stack on the card (one cluster of CTAs a
    lane), the loop of (b, n) masked argmins on the CPU.  Every lane gets the order of
    ``vat_order`` on its matrix, bit for bit.

    Returns:
      (b, n) int64 — lane z's VAT visit order.
    """
    i0 = torch.argmax(torch.amax(R, dim=2), dim=1)          # (b,)
    return kops.vat_prim_order(R, i0)


def reorder_batch(R: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """R*[z] = R[z][order[z]][:, order[z]] for every lane — two gathers."""
    b, n, _ = R.shape
    rows = torch.gather(R, 1, order[:, :, None].expand(b, n, n))
    return torch.gather(rows, 2, order[:, None, :].expand(b, n, n))


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


def vat_batch(X: torch.Tensor, *, metric: str = "euclidean",
              form: str = "gram") -> VATResult:
    """Batched VAT: a stack of datasets in the launches of one.

    Args:
      X: (b, n, d) float32 (or bfloat16 storage) — b datasets of n points.
      metric: one of ``kernels.ref.METRICS``; for precomputed (b, n, n)
        stacks use ``vat_batch_from_dist``.
      form: "gram" (default) or "direct".

    Returns:
      VATResult with a leading lane axis: rstar (b, n, n), order (b, n)
      int64, dist (b, n, n).  Lane z equals ``vat(X[z])`` bit for bit.
    """
    R = kops.pairwise_dist_batch(X, metric=metric, form=form)
    return vat_batch_from_dist(R)


def vat_batch_from_dist(R: torch.Tensor) -> VATResult:
    """Batched ``vat_from_dist``: (b, n, n) stack -> batched VATResult
    (``dist`` aliasing R)."""
    order = vat_order_batch(R)
    return VATResult(rstar=reorder_batch(R, order), order=order, dist=R)


# ------------------------------------------------------------------------
# Flash-VAT: the matrix-free Prim ordering — exact VAT at O(n·d) memory.
# ------------------------------------------------------------------------

#: Largest (rows, columns) block of the seed scan: 64 MiB of f32 output, so
#: n = 50,000 takes 25 x 7 = 175 pairwise launches.
SEED_BLOCK = (2_048, 8_192)

#: The persistent kernel's schedule for the flashvat engines: eager (every
#: live tile folds every step).  On an H100 it beat the lazily pruned
#: schedule at every shape chip_smoke.py times (its ``blocks`` line), since
#: a step costs one group exchange either way and pruning adds the bounds,
#: the catch-up folds and a second key per tile; both give the same bits.
PERSIST_PRUNE = False


def _split(n: int, most: int) -> int:
    """Block length for n lanes: at least two blocks (so a block never
    spans all n), none longer than ``most``, all about even."""
    parts = max(2, -(-n // most))
    return -(-n // parts)


def _seed_rowmax(Xr: torch.Tensor, Xc: torch.Tensor, *, r0: int, n: int,
                 metric: str, form: str = "gram") -> torch.Tensor:
    """Row maxima of the rows ``r0 .. r0 + len(Xr) - 1`` of R over its n
    columns, without forming those rows.

    Blocks of R come from ``kernels.ops.pairwise_dist(xb, yb)`` — two
    operands, each shorter than its side — with the diagonal (at global
    coordinates) masked to 0, as in the materialized matrix, and are
    reduced to row maxima on the spot.  Every entry depends only on its own
    pair and the max is exact, so any blocking gives the same row maxima:
    the sharded engine's scan of its rows equals these rows of the solo
    scan.

    Args:
      Xr: (nr, d) float32 — the rows' points.
      Xc: (>= n, d) float32 — the column points; rows past n are padding
        and are not scanned.
      r0: the global index of Xr's first row.
      n: the number of columns.

    Returns:
      (nr,) float32 row maxima on Xr's device; no host sync.
    """
    nr = Xr.shape[0]
    br, bc = _split(nr, SEED_BLOCK[0]), _split(n, SEED_BLOCK[1])
    rowmax = torch.empty(nr, dtype=torch.float32, device=Xr.device)
    for a in range(0, nr, br):
        b = min(nr, a + br)
        rm = None
        for c0 in range(0, n, bc):
            c1 = min(n, c0 + bc)
            T = kops.pairwise_dist(Xr[a:b], Xc[c0:c1], metric=metric,
                                   form=form)
            lo, hi = max(r0 + a, c0), min(r0 + b, c1)
            if lo < hi:   # the block holds part of the diagonal
                diag = torch.arange(lo, hi, device=Xr.device)
                T[diag - r0 - a, diag - c0] = 0.0
            bm = torch.amax(T, dim=1)
            rm = bm if rm is None else torch.maximum(rm, bm)
        rowmax[a:b] = rm
    return rowmax


def _streamed_seed_pivot(Xf: torch.Tensor, *, metric: str,
                         form: str = "gram") -> torch.Tensor:
    """VAT's seed i0 = argmax_i max_j R[i, j], without forming R: the
    argmax of ``_seed_rowmax`` over all n rows, so the seed equals
    ``vat_order``'s on the materialized matrix.

    Returns:
      0-d int64 tensor on Xf's device (the first index wins ties); no
      host sync.
    """
    n = Xf.shape[0]
    if n == 1:
        return torch.zeros((), dtype=torch.int64, device=Xf.device)
    return torch.argmax(_seed_rowmax(Xf, Xf, r0=0, n=n, metric=metric,
                                     form=form))


def _prim_stream_order(Xf: torch.Tensor, aux: torch.Tensor,
                       i0: torch.Tensor, *, metric: str,
                       form: str) -> FlashVATResult:
    """n - 1 fused Prim steps from seed i0 (the stepwise engine).

    The frontier starts at +inf, the seed is selected and recorded; each
    step reads its pivot from the order, folds its row and records the next
    vertex itself (``kernels.ops.prim_stream_stepper``): on the card one
    launch a step and no other op, so the loop enqueues without a host
    sync.
    """
    n = Xf.shape[0]
    dev = Xf.device
    q = i0.view(1)
    mind = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    sel = torch.zeros(n, dtype=torch.bool, device=dev)
    sel.index_fill_(0, q, True)
    order = torch.zeros(n, dtype=torch.int64, device=dev)
    order[0:1] = q
    edges = torch.zeros(n, dtype=torch.float32, device=dev)
    step = kops.prim_stream_stepper(Xf, aux, mind, sel, order, edges,
                                    metric=metric, form=form)
    for t in range(1, n):
        step(t)
    return FlashVATResult(order=order, edges=edges)


def vat_matrix_free(X: torch.Tensor, *, metric: str = "euclidean",
                    form: str = "gram", block: int = DEFAULT_BLOCK,
                    turbo: bool = True) -> FlashVATResult:
    """Exact VAT ordering of X without ever forming the (n, n) matrix.

    The seed comes from a streamed row-max scan (``_streamed_seed_pivot``),
    then the Prim traversal runs through one of two engines:

      * ``turbo=True`` (default): ``kernels.ops.prim_persist`` — on the
        card one launch of the persistent kernel, all n - 1 steps, in the
        schedule ``PERSIST_PRUNE`` names;
      * ``turbo=False``: n - 1 launches of the fused step kernel, each
        recording its vertex (``kernels.ops.prim_stream_stepper``).

    Both give the order and edges of ``vat_order`` on the materialized
    matrix of the same device bit for bit: the same per-pair code, exact
    f32 min folds, the same first-index tie rule and seed rule.  Memory is
    O(n·d) for X plus O(n) of state, and the seed scan's blocks
    (``SEED_BLOCK``).

    Args:
      X: (n, d) float — data points (cast to f32).
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" (default) or "direct" — the tile form of the seed scan
        and the traversal alike.
      block: tile length of the persistent kernel; it changes its work,
        never its result.
      turbo: persistent engine (True) or stepwise (False).

    Returns:
      FlashVATResult — ``order`` (n,) int64 and ``edges`` (n,) f32, the
      MST edge weight that admitted each vertex (edges[0] = 0).
    """
    Xf = X.float().contiguous()
    aux = kops.metric_aux(Xf, metric=metric)
    i0 = _streamed_seed_pivot(Xf, metric=metric, form=form)
    if turbo:
        order, edges = kops.prim_persist(Xf, aux, i0, metric=metric,
                                         form=form, block=block,
                                         prune=PERSIST_PRUNE)
        return FlashVATResult(order=order, edges=edges)
    return _prim_stream_order(Xf, aux, i0, metric=metric, form=form)


def _prim_stream_order_batch(Xf: torch.Tensor, aux: torch.Tensor,
                             i0: torch.Tensor, *, metric: str,
                             form: str) -> FlashVATResult:
    """n - 1 batched fused Prim steps from seeds i0 (b,): each step is one
    launch for all lanes, which reads lane z's pivot from ``order[z, t -
    1]`` and records its next vertex; no host sync."""
    b, n, _ = Xf.shape
    dev = Xf.device
    mind = torch.full((b, n), torch.inf, dtype=torch.float32, device=dev)
    sel = torch.zeros((b, n), dtype=torch.bool, device=dev)
    sel.scatter_(1, i0.view(b, 1), True)
    order = torch.zeros((b, n), dtype=torch.int64, device=dev)
    order[:, 0] = i0
    edges = torch.zeros((b, n), dtype=torch.float32, device=dev)
    step = kops.prim_stream_stepper(Xf, aux, mind, sel, order, edges,
                                    metric=metric, form=form)
    for t in range(1, n):
        step(t)
    return FlashVATResult(order=order, edges=edges)


def vat_matrix_free_batch(X: torch.Tensor, *, metric: str = "euclidean",
                          form: str = "gram", block: int = DEFAULT_BLOCK,
                          turbo: bool = True) -> FlashVATResult:
    """Batched Flash-VAT: exact matrix-free orderings of a (b, n, d) stack.

    The aux vectors come in one pre-pass over all b·n rows; each lane's seed
    from its own streamed scan (``_streamed_seed_pivot``, per lane, through
    the single pairwise kernel's blocks); then the traversal for all lanes:

      * ``turbo=True``: one launch of the persistent kernel with a group
        of CTAs per lane (``kernels.ops.prim_persist`` on the stack) — where
        the reference vmaps its XLA mirror;
      * ``turbo=False``: n - 1 launches of the batched step kernel.

    Lane z equals ``vat_matrix_free(X[z])`` bit for bit under either
    engine.  Memory is O(b·n·d) plus O(b·n) of state; no (b, n, n) or
    (n, n) object.

    Returns:
      FlashVATResult with a leading lane axis: order (b, n) int64, edges
      (b, n) f32.
    """
    Xf = X.float().contiguous()
    aux = kops.metric_aux(Xf, metric=metric)
    i0 = torch.stack([_streamed_seed_pivot(x, metric=metric, form=form)
                      for x in Xf])
    if turbo:
        order, edges = kops.prim_persist(Xf, aux, i0, metric=metric,
                                         form=form, block=block,
                                         prune=PERSIST_PRUNE)
        return FlashVATResult(order=order, edges=edges)
    return _prim_stream_order_batch(Xf, aux, i0, metric=metric, form=form)


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

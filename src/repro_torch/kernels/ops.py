"""Public wrappers of the kernels package: the device decides the path.

A CUDA tensor launches the hand-written CUDA kernel (``pairwise_dist.py``,
``prim_update.py``, ``ivat_update.py``, ``prim_persist.py``,
``prim_stream.py``, ``knn_graph.py``); a CPU tensor takes the plain PyTorch
version in ``ref.py``.  There is no other switch and no fallback: a
CUDA tensor the kernel refuses raises.  The one rule besides the device is
the kNN graph's, as in the reference: past ``MAX_K`` neighbours the card
takes the blocked route (``knn_topk_blocked``), chosen by k before any
launch.  ``launch_counts()`` reads how often
each kernel was launched since ``reset_launch_counts()``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.ivat_update import ivat_from_vat_cuda
from repro_torch.kernels.knn_graph import (MAX_K, knn_topk_blocked,
                                          knn_topk_cuda)
from repro_torch.kernels.pairwise_dist import (metric_aux_cuda,
                                              pairwise_dist_cuda)
from repro_torch.kernels.prim_persist import DEFAULT_BLOCK, prim_persist_cuda
from repro_torch.kernels.prim_stream import prim_stream_step_cuda
from repro_torch.kernels.prim_update import masked_argmin_cuda

__all__ = ["pairwise_dist", "masked_argmin", "ivat_from_vat", "metric_aux",
           "prim_persist", "prim_stream_step", "knn_topk", "knn_graph",
           "MAX_K", "launch_counts", "reset_launch_counts"]


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


def metric_aux(X: torch.Tensor, *, metric: str = "euclidean") -> torch.Tensor:
    """(n,) f32 aux vector of X for the Prim paths (``ref.metric_aux_ref``'s
    values); on the card the pairwise kernel's own row norms, so a
    matrix-free row equals the materialized row bit for bit."""
    if X.is_cuda:
        return metric_aux_cuda(X, metric=metric)
    return ref.metric_aux_ref(X, metric=metric)


def prim_persist(X: torch.Tensor, aux: torch.Tensor, i0: torch.Tensor, *,
                 metric: str = "euclidean", form: str = "gram",
                 block: int = DEFAULT_BLOCK, prune: bool = True):
    """The whole exact Prim traversal from seed ``i0``.

    On the card: the persistent kernel, one launch, lazily pruned tiles of
    ``block`` lanes.  On the CPU: ``ref.prim_persist_ref``, the eager
    schedule; ``block`` and ``prune`` change the work, never a bit of the
    result, so the plain version ignores them.

    Returns:
      (order (n,) int64, edges (n,) f32) on X's device.
    """
    _dispatch_site("prim_persist", X.device)
    if X.is_cuda:
        order, edges, _ = prim_persist_cuda(X, aux, i0, metric=metric,
                                            form=form, block=block,
                                            prune=prune)
        return order, edges
    return ref.prim_persist_ref(X, aux, i0, metric=metric, form=form)


def prim_stream_step(X: torch.Tensor, aux: torch.Tensor, q: torch.Tensor,
                     mind: torch.Tensor, selected: torch.Tensor, *,
                     metric: str = "euclidean", form: str = "gram"):
    """One matrix-free Prim step: fold pivot q's row into ``mind``, then the
    masked first-index (min, argmin).

    Returns:
      (new_mind (n,) f32, edge f32 0-d, next int64 0-d).  On the card
      ``new_mind`` is ``mind`` updated in place; on the CPU a new tensor.
    """
    _dispatch_site("prim_stream_step", X.device)
    if X.is_cuda:
        return prim_stream_step_cuda(X, aux, q, mind, selected,
                                     metric=metric, form=form)
    return ref.prim_stream_step_ref(X, aux, q, mind, selected, metric=metric,
                                    form=form)


def knn_topk(Xq: torch.Tensor, Xc: torch.Tensor, qid: torch.Tensor,
             cid: torch.Tensor, *, k: int, metric: str = "euclidean"):
    """k nearest candidates of every query, ascending by (value, id).

    On the card, ``k <= MAX_K`` launches the kNN kernel and ``k > MAX_K``
    takes ``knn_topk_blocked`` (``pairwise_dist`` kernel tiles merged by
    stable sorts): a documented rule on k, as the reference's dispatch at
    that k (``repro/kernels/ops.py:134-140``), not a fallback on failure —
    the route is chosen before any launch, and a launch that fails raises.
    On the CPU: ``ref.knn_topk_ref``.

    Args:
      Xq: (nq, d) float32 — queries.
      Xc: (nc, d) float32 — candidates.
      qid: (nq,) int64 — query ids (a sentinel such as -1 for queries
        that are no candidate).
      cid: (nc,) int64 — candidate ids; < 0 marks padding.
      k: neighbours per query (>= 1; k > nc leaves (+inf, -1) slots).
      metric: one of ``ref.METRICS`` (gram form always).

    Returns:
      (dist (nq, k) f32, idx (nq, k) int64); a candidate with ``cid < 0``
      or ``cid == qid`` of its row never appears.
    """
    _dispatch_site("knn_graph", Xq.device)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not Xq.is_cuda:
        return ref.knn_topk_ref(Xq, Xc, qid, cid, k=k, metric=metric)
    if k <= MAX_K:
        return knn_topk_cuda(Xq, Xc, qid, cid, k=k, metric=metric)
    return knn_topk_blocked(Xq, Xc, qid, cid, k=k, metric=metric)


def knn_graph(X: torch.Tensor, *, k: int, metric: str = "euclidean"):
    """k-nearest-neighbour graph at O(n·k) memory; never builds (n, n) on
    the card.

    ``knn_topk`` with Xq = Xc = X and qid = cid = 0..n-1, so the self-pair
    is the masked ``cid == qid`` case.

    Args:
      X: (n, d) float32 — data points.
      k: neighbours per point, 1 <= k <= n - 1.
      metric: one of ``ref.METRICS``.

    Returns:
      (dist (n, k) f32 ascending per row, idx (n, k) int64) — idx[i, 0] is
      i's nearest neighbour, the lower index first among equal distances;
      a point is never its own neighbour.
    """
    n = X.shape[0]
    if not 1 <= k <= n - 1:
        raise ValueError(f"k must satisfy 1 <= k <= n-1 = {n - 1}, got {k}")
    ids = torch.arange(n, device=X.device)
    return knn_topk(X, X, ids, ids, k=k, metric=metric)

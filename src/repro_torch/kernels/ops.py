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

Batched fits (``fit_many``) take the same wrappers with a leading lane axis:
``pairwise_dist_batch`` and ``knn_graph_batch`` for (b, n, d) stacks, and
``masked_argmin``, ``vat_prim_order``, ``metric_aux``, ``prim_stream_step``
and ``prim_persist`` on (b, ...) operands.  Every lane's result equals the call
on that lane alone, bit for bit, on either device.

The step-by-step engines build their step once a traversal
(``prim_stream_stepper``, ``prim_frontier_stepper``): on the card each
step is then one C call and one launch, the checks, the copies and the
scratch done at the build.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import faults
from repro_torch.kernels import ref
from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.ivat_update import ivat_from_vat_cuda
from repro_torch.kernels.knn_graph import (MAX_K, knn_graph_batch_cuda,
                                          knn_topk_blocked, knn_topk_cuda,
                                          knn_topk_segmented_cuda)
from repro_torch.kernels.pairwise_dist import (metric_aux_cuda,
                                              pairwise_dist_batch_cuda,
                                              pairwise_dist_cuda)
from repro_torch.kernels.prim_persist import DEFAULT_BLOCK, prim_persist_cuda
from repro_torch.kernels.prim_stream import (FrontierStep, StreamRecord,
                                            prim_frontier_step_cuda,
                                            prim_stream_step_batch_cuda,
                                            prim_stream_step_cuda)
from repro_torch.kernels.prim_update import (masked_argmin_cuda,
                                             vat_prim_order_cuda)

__all__ = ["pairwise_dist", "pairwise_dist_batch", "masked_argmin",
           "vat_prim_order", "ivat_from_vat", "metric_aux", "prim_persist",
           "prim_stream_step", "prim_stream_stepper", "prim_frontier_step",
           "prim_frontier_stepper", "knn_topk",
           "knn_topk_segmented", "knn_graph", "knn_graph_batch", "MAX_K",
           "launch_counts", "reset_launch_counts"]


def _dispatch_site(op: str, device: torch.device) -> None:
    """The ``kernels.dispatch`` fault-injection site, called at the top of
    every public wrapper.  The context carries the reference's keys,
    ``op`` and ``use_pallas`` (True when the call goes to a CUDA kernel),
    and the ``device``; disarmed, ``fault_point`` returns after one dict
    truthiness check."""
    faults.fault_point("kernels.dispatch", context={
        "op": op, "use_pallas": device.type == "cuda",
        "device": str(device)})


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
    if X.is_cuda:   # the kernel writes the self-matrix's zero diagonal
        return pairwise_dist_cuda(X, Y, metric=metric, form=form,
                                  zero_diag=Y is None)
    R = ref.pairwise_dissim_ref(X, Y, metric=metric, form=form)
    if Y is None:  # exact zero diagonal for self-dissimilarities
        R.fill_diagonal_(0.0)
    return R


def pairwise_dist_batch(X: torch.Tensor, *, metric: str = "euclidean",
                        form: str = "gram") -> torch.Tensor:
    """Per-dataset self-dissimilarity matrices of a (b, n, d) stack; one
    launch of the batched CUDA kernel on the card.

    Args:
      X: (b, n, d) float — b independent datasets.
      metric: one of ``ref.METRICS``.
      form: "gram" (default) or "direct" — the numerics-policy tile form.

    Returns:
      (b, n, n) float32 stack with exactly-zero diagonals; lane z equals
      ``pairwise_dist(X[z])`` bit for bit.
    """
    _dispatch_site("pairwise_dist_batch", X.device)
    if X.is_cuda:
        return pairwise_dist_batch_cuda(X, metric=metric, form=form)
    R = ref.pairwise_dissim_batch_ref(X, metric=metric, form=form)
    torch.diagonal(R, dim1=-2, dim2=-1).zero_()
    return R


def masked_argmin(vals: torch.Tensor, mask: torch.Tensor):
    """(min, argmin) over unmasked entries (mask=True excludes).

    Args:
      vals: (n,) float32, or a (b, n) stack reduced row by row (one launch
        for the stack on the card).
      mask: bool of vals' shape.

    Returns:
      (f32, int64) on vals' device — 0-d, or (b,) for a stack —
      first-index tie-breaking.
    """
    _dispatch_site("masked_argmin", vals.device)
    if vals.is_cuda:
        return masked_argmin_cuda(vals, mask)
    return ref.masked_argmin_ref(vals, mask)


def vat_prim_order(R: torch.Tensor, i0: torch.Tensor) -> torch.Tensor:
    """Prim's VAT order of a dissimilarity matrix from seed ``i0``.

    On the card one launch of the Prim kernel (one thread-block cluster a
    matrix, the frontier in its CTAs' shared memory); on the CPU
    ``ref.vat_prim_order_ref``, the loop of ``masked_argmin`` steps, whose
    order the kernel gives bit for bit.

    Args:
      R: (n, n) float32, or a (b, n, n) stack (one launch for the stack).
      i0: int64 seed (one element), or (b,) seeds for a stack.

    Returns:
      (n,) int64 visit order, or (b, n); greedy min-edge growth with
      first-index tie-breaking.
    """
    _dispatch_site("vat_prim_order", R.device)
    if R.is_cuda:
        return vat_prim_order_cuda(R, i0)
    return ref.vat_prim_order_ref(R, i0)


def ivat_from_vat(rstar: torch.Tensor) -> torch.Tensor:
    """iVAT geodesic transform of VAT-ordered dissimilarities.

    On the card four launches over all lanes (``ivat_update.py``): lanes in
    Prim order take the range route, others the serial recurrence; on the
    CPU the recurrence (``ref.ivat_from_vat_ref``), lane by lane.

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
    values; (b, n) for a (b, n, d) stack); on the card the pairwise kernel's
    own row norms, so a matrix-free row equals the materialized row bit for
    bit."""
    if X.is_cuda:
        return metric_aux_cuda(X, metric=metric)
    return ref.metric_aux_ref(X, metric=metric)


def prim_persist(X: torch.Tensor, aux: torch.Tensor, i0: torch.Tensor, *,
                 metric: str = "euclidean", form: str = "gram",
                 block: int = DEFAULT_BLOCK, prune: bool = True):
    """The whole exact Prim traversal from seed ``i0``.

    On the card: the persistent kernel, one launch, lazily pruned tiles of
    ``block`` lanes spread over a group of CTAs (``prim_persist.
    persist_plan``); a (b, n, d) stack (aux (b, n), i0 (b,)) is one launch
    of b groups.  On the CPU: ``ref.prim_persist_ref`` (per lane for a
    stack), the eager schedule; ``block`` and ``prune`` change the work,
    never a bit of the result, so the plain version ignores them.

    Returns:
      (order (n,) int64, edges (n,) f32) on X's device; (b, n) each for a
      stack.
    """
    _dispatch_site("prim_persist", X.device)
    if X.is_cuda:
        order, edges, _ = prim_persist_cuda(X, aux, i0, metric=metric,
                                            form=form, block=block,
                                            prune=prune)
        return order, edges
    if X.dim() == 3:
        return ref.prim_persist_batch_ref(X, aux, i0, metric=metric,
                                          form=form)
    return ref.prim_persist_ref(X, aux, i0, metric=metric, form=form)


def prim_stream_step(X: torch.Tensor, aux: torch.Tensor, q: torch.Tensor,
                     mind: torch.Tensor, selected: torch.Tensor, *,
                     metric: str = "euclidean", form: str = "gram"):
    """One matrix-free Prim step: fold pivot q's row into ``mind``, then the
    masked first-index (min, argmin).  A (b, n, d) stack (aux, mind,
    selected (b, n), q (b,)) steps every lane at once: on the card one
    launch of the batched kernel.

    Returns:
      (new_mind (n,) f32, edge f32 0-d, next int64 0-d); (b, n), (b,) and
      (b,) for a stack.  On the card ``new_mind`` is ``mind`` updated in
      place; on the CPU a new tensor.
    """
    batched = X.dim() == 3
    _dispatch_site("prim_stream_step", X.device)
    if X.is_cuda:
        step = prim_stream_step_batch_cuda if batched else \
            prim_stream_step_cuda
        return step(X, aux, q, mind, selected, metric=metric, form=form)
    step = ref.prim_stream_step_batch_ref if batched else \
        ref.prim_stream_step_ref
    return step(X, aux, q, mind, selected, metric=metric, form=form)


def prim_frontier_step(X: torch.Tensor, aux: torch.Tensor,
                       table: torch.Tensor, mind: torch.Tensor,
                       slot: torch.Tensor, order: torch.Tensor,
                       edges: torch.Tensor, t: int, *, offset: int = 0,
                       metric: str = "euclidean", form: str = "gram"):
    """One step of the sharded engine (``core.distributed.
    vat_matrix_free_sharded``) on this rank's shard.

    The pivot is the least-key slot of ``table``, the slots every rank
    wrote last step, all-gathered; it is recorded as ``order[t]`` and
    ``edges[t]``, its lane is closed to +inf on the rank that holds it, its
    row is folded into the in-band frontier (``ref.prim_frontier_step_ref``:
    +inf lanes stay +inf), and the shard's first-index minimum, with its
    global id ``offset + idx``, its aux entry and its point, is written to
    ``slot`` for the next all-gather.  The reference's Pallas route derives
    a ``selected`` mask from the +inf lanes and re-masks the folded
    frontier; the port's kernel is in band itself and needs neither.

    On the card one launch of the frontier kernel; on the CPU
    ``ref.prim_frontier_round_ref``.

    Args:
      X: (n, d) float32 — the shard; aux (n,) its ``metric_aux``.
      table: (P, ref.slot_width(d)) float32 — the gathered slots.
      mind: (n,) float32 — the in-band frontier.
      slot: (ref.slot_width(d),) float32 — receives this rank's next slot.
      order, edges: (N,) int64 and float32 — the traversal being recorded.
      t: the pivot's position in the order.
      offset: the global id of the shard's first lane.
      metric: one of ``ref.METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      the folded frontier: ``mind`` updated in place on the card, a new
      tensor on the CPU.
    """
    _dispatch_site("prim_frontier_step", X.device)
    if X.is_cuda:
        return prim_frontier_step_cuda(X, aux, table, mind, slot, order,
                                       edges, t, offset=offset,
                                       metric=metric, form=form)
    new_mind, new_slot = ref.prim_frontier_round_ref(
        X, aux, table, mind, order, edges, t, offset=offset, metric=metric,
        form=form)
    slot.copy_(new_slot)
    return new_mind


def prim_stream_stepper(X: torch.Tensor, aux: torch.Tensor,
                        mind: torch.Tensor, selected: torch.Tensor,
                        order: torch.Tensor, edges: torch.Tensor, *,
                        metric: str = "euclidean", form: str = "gram"):
    """The stepwise engine's recording step for one traversal, built once:
    ``step(t)`` folds pivot ``order[.., t - 1]`` into ``mind`` and writes
    the masked first-index minimum to ``order[.., t]``, ``edges[.., t]``
    and ``selected``, all in place (``ref.prim_stream_record_ref``).  X is
    (n, d) or a (b, n, d) stack, the other tensors (n,) or (b, n).

    On the card ``prim_stream.StreamRecord``: one C call and one kernel
    launch a step; on the CPU the plain version bound to the tensors.
    """
    _dispatch_site("prim_stream_step", X.device)
    if X.is_cuda:
        return StreamRecord(X, aux, mind, selected, order, edges,
                            metric=metric, form=form)
    return functools.partial(ref.prim_stream_record_ref, X, aux, mind,
                             selected, order, edges, metric=metric,
                             form=form)


def prim_frontier_stepper(X: torch.Tensor, aux: torch.Tensor,
                          table: torch.Tensor, mind: torch.Tensor,
                          slot: torch.Tensor, order: torch.Tensor,
                          edges: torch.Tensor, *, offset: int = 0,
                          metric: str = "euclidean", form: str = "gram"):
    """The sharded engine's step for one traversal of this rank's shard,
    built once: ``step(t)`` is ``prim_frontier_step`` at t with ``mind``
    and ``slot`` updated in place.

    On the card ``prim_stream.FrontierStep``: one C call and one kernel
    launch a step; on the CPU a call of ``prim_frontier_step`` (the plain
    ``ref.prim_frontier_round_ref``) a step.
    """
    if X.is_cuda:
        _dispatch_site("prim_frontier_step", X.device)
        return FrontierStep(X, aux, table, mind, slot, order, edges,
                            offset=offset, metric=metric, form=form)

    def step(t: int) -> None:
        mind.copy_(prim_frontier_step(X, aux, table, mind, slot, order,
                                      edges, t, offset=offset, metric=metric,
                                      form=form))
    return step


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


def knn_topk_segmented(Xq: torch.Tensor, Xc: torch.Tensor,
                       qid: torch.Tensor, cid: torch.Tensor,
                       qoff: torch.Tensor, coff: torch.Tensor, *, k: int,
                       metric: str = "euclidean"):
    """``knn_topk`` of many independent segments: segment g's queries
    ``Xq[qoff[g]:qoff[g+1]]`` (ids ``qid``) against its candidates
    ``Xc[coff[g]:coff[g+1]]`` (ids ``cid``).

    On the card ``k <= MAX_K`` is one launch of the kNN kernel for every
    segment and ``k > MAX_K`` takes ``knn_topk_blocked`` segment by
    segment, the rule on k of ``knn_topk``, chosen before any launch.  On
    the CPU: ``ref.knn_topk_segmented_ref``.

    Args:
      Xq: (Q, d) float32 — the segments' queries, segment by segment.
      Xc: (C, d) float32 — the segments' candidates.
      qid: (Q,) int64; cid: (C,) int64 (< 0 marks padding).
      qoff, coff: (c + 1,) int64 offsets on Xq's device, from 0 to Q and C.
      k: neighbours per query (>= 1).
      metric: one of ``ref.METRICS`` (gram form always).

    Returns:
      (dist (Q, k) f32, idx (Q, k) int64): row i equals ``knn_topk`` of
      query i against its segment's candidates, bit for bit; a segment with
      no candidates, or fewer valid ones than k, leaves (+inf, -1) slots.
    """
    _dispatch_site("knn_graph_segmented", Xq.device)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not Xq.is_cuda:
        return ref.knn_topk_segmented_ref(Xq, Xc, qid, cid, qoff, coff, k=k,
                                          metric=metric)
    if k <= MAX_K:
        return knn_topk_segmented_cuda(Xq, Xc, qid, cid, qoff, coff, k=k,
                                       metric=metric)
    return ref.knn_topk_segmented_ref(Xq, Xc, qid, cid, qoff, coff, k=k,
                                      metric=metric, topk=knn_topk_blocked)


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


def knn_graph_batch(X: torch.Tensor, *, k: int, metric: str = "euclidean"):
    """Per-dataset kNN graphs of a (b, n, d) stack.

    On the card ``k <= MAX_K`` is one launch of the batched kNN kernel and
    ``k > MAX_K`` takes ``knn_topk_blocked`` lane by lane, the rule on k
    that ``knn_topk`` applies, chosen before any launch.  On the CPU:
    ``ref.knn_graph_batch_ref``.

    Args:
      X: (b, n, d) float32 — b independent datasets.
      k: neighbours per point, 1 <= k <= n - 1.
      metric: one of ``ref.METRICS``.

    Returns:
      (dist (b, n, k) f32, idx (b, n, k) int64), lane z equal to
      ``knn_graph(X[z])`` bit for bit; ids are lane-local.
    """
    _dispatch_site("knn_graph_batch", X.device)
    n = X.shape[1]
    if not 1 <= k <= n - 1:
        raise ValueError(f"k must satisfy 1 <= k <= n-1 = {n - 1}, got {k}")
    if not X.is_cuda:
        return ref.knn_graph_batch_ref(X, k=k, metric=metric)
    if k <= MAX_K:
        return knn_graph_batch_cuda(X, k=k, metric=metric)
    ids = torch.arange(n, device=X.device)
    graphs = [knn_topk_blocked(x, x, ids, ids, k=k, metric=metric)
              for x in X]
    return (torch.stack([g[0] for g in graphs]),
            torch.stack([g[1] for g in graphs]))

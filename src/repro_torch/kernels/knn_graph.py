"""CUDA kernel: the k nearest candidates of every query, for the kNN graph.

The port of ``repro/kernels/knn_graph.py::knn_graph_pallas``.  The kernel is
``csrc/knn_graph.cu`` (its opening note gives the design and what bounds
it): gram-form tiles, masking by ids, and a sorted list of k packed
(value, id) keys per query row, so the lower id wins a tie whatever order
the tiles run in.  This module checks the inputs, takes the aux vectors
from the pairwise kernel's row-norm pre-pass, allocates the outputs and
launches on the current stream; ``kernels/ops.py`` sends CPU tensors to
``ref.py`` instead.

``knn_topk_blocked`` is the counterpart of the reference's
``knn_graph_blocked``: the route ``ops.knn_topk`` takes on the card for
k > ``MAX_K``, chosen by k before any launch.

``knn_graph_batch_cuda`` is the port of ``knn_graph_pallas_batch``: the
kNN graph of each lane of a (b, n, d) stack in one launch.

``knn_topk_segmented_cuda`` runs many independent query/candidate problems
(the anchored search's cells) in one launch of the same kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pairwise_dist import (check_cuda, check_lanes,
                                              metric_aux_cuda,
                                              pairwise_dist_cuda)

#: Largest k the kernel keeps per row (the reference's ``MAX_PALLAS_K``);
#: ``ops.knn_topk`` takes ``knn_topk_blocked`` past it.
MAX_K = 128

#: The kernel's metric kind per metric (``enum Kind`` in dissim.cuh): the
#: gram form always, as the reference's kNN tiles (``knn_graph.py:92-95``).
_KINDS = {"sqeuclidean": 0, "euclidean": 1, "cosine": 2, "manhattan": 5}


def _check_inputs(Xq, Xc, qid, cid, k, metric) -> None:
    ref.check_metric(metric)
    for t, name in ((Xq, "Xq"), (Xc, "Xc"), (qid, "qid"), (cid, "cid")):
        check_cuda(t, name)
    if Xq.dtype != torch.float32 or Xc.dtype != torch.float32:
        raise ValueError(f"Xq and Xc must be float32, got {Xq.dtype} and "
                         f"{Xc.dtype}")
    if Xq.dim() != 2 or Xc.dim() != 2 or Xq.shape[1] != Xc.shape[1] \
            or 0 in Xq.shape or 0 in Xc.shape:
        raise ValueError(f"want non-empty Xq (nq, d) and Xc (nc, d), got "
                         f"{tuple(Xq.shape)} and {tuple(Xc.shape)}")
    if qid.dtype != torch.int64 or cid.dtype != torch.int64 \
            or qid.shape != Xq.shape[:1] or cid.shape != Xc.shape[:1]:
        raise ValueError(f"want int64 qid (nq,) and cid (nc,), got "
                         f"{qid.dtype} {tuple(qid.shape)} and {cid.dtype} "
                         f"{tuple(cid.shape)}")


def knn_topk_cuda(Xq: torch.Tensor, Xc: torch.Tensor, qid: torch.Tensor,
                  cid: torch.Tensor, *, k: int, metric: str = "euclidean"):
    """k nearest candidates of every query, on the card.

    Args:
      Xq: (nq, d) contiguous float32 CUDA tensor — query points.
      Xc: (nc, d) like Xq — candidate points (may be Xq itself).
      qid: (nq,) int64 — query ids (a sentinel such as -1 for a query that
        is no candidate).
      cid: (nc,) int64 — candidate ids, each below 2^32; < 0 marks padding.
      k: neighbours per query, 1 <= k <= ``MAX_K``.
      metric: one of ``kernels.ref.METRICS`` (gram form).

    Returns:
      (dist (nq, k) f32, idx (nq, k) int64): ascending by (value,
      candidate id); a candidate with ``cid < 0`` or ``cid == qid`` of its
      row never appears, and a slot no valid candidate fills holds
      (+inf, -1).  Each value equals the ``pairwise_dist`` kernel's entry
      for the same pair, bit for bit.
    """
    _check_inputs(Xq, Xc, qid, cid, k, metric)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kNN kernel keeps 1 <= k <= {MAX_K} "
                         f"neighbours, got k={k}")
    nq, d = Xq.shape
    nc = Xc.shape[0]
    aq = ac = None
    if metric != "manhattan":
        aq = metric_aux_cuda(Xq, metric=metric)
        ac = aq if Xc is Xq else metric_aux_cuda(Xc, metric=metric)
    dist = torch.empty((nq, k), dtype=torch.float32, device=Xq.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=Xq.device)
    lib = _build.library()
    err = lib.repro_knn_topk(
        Xq.data_ptr(), Xc.data_ptr(), 0 if aq is None else aq.data_ptr(),
        0 if ac is None else ac.data_ptr(), qid.data_ptr(), cid.data_ptr(),
        nq, nc, d, k, _KINDS[metric], dist.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_graph")
    _build.LAUNCHES["knn_graph"] += 1
    return dist, idx


def knn_topk_segmented_cuda(Xq: torch.Tensor, Xc: torch.Tensor,
                            qid: torch.Tensor, cid: torch.Tensor,
                            qoff: torch.Tensor, coff: torch.Tensor, *, k: int,
                            metric: str = "euclidean"):
    """``knn_topk_cuda`` of every segment at once: one launch, one aux
    pre-pass over Xq and one over Xc.

    Segment g is the problem ``knn_topk_cuda(Xq[qoff[g]:qoff[g+1]],
    Xc[coff[g]:coff[g+1]], qid[...], cid[...])``; the kernel's work list
    gives it ceil(q_g / ``_build.KNN_BLOCK_ROWS``) CTAs.  A list is a
    function of its row's candidate keys alone, so each segment's rows are
    that call's bits; a segment with no candidates, or fewer valid ones
    than k, fills the rest with (+inf, -1).

    Args:
      Xq: (Q, d) contiguous float32 CUDA tensor — every segment's queries,
        segment by segment; qid (Q,) int64 their ids.
      Xc: (C, d) like Xq — every segment's candidates; cid (C,) int64, each
        below 2^32, < 0 marks padding.
      qoff, coff: (c + 1,) int64 offsets on the card, from 0 to Q and to C.
      k: neighbours per query, 1 <= k <= ``MAX_K``.
      metric: one of ``kernels.ref.METRICS`` (gram form).

    Returns:
      (dist (Q, k) f32, idx (Q, k) int64), row i the list of query i.
    """
    _check_inputs(Xq, Xc, qid, cid, k, metric)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kNN kernel keeps 1 <= k <= {MAX_K} "
                         f"neighbours, got k={k}")
    for t, name in ((qoff, "qoff"), (coff, "coff")):
        check_cuda(t, name)
        if t.dtype != torch.int64 or t.dim() != 1 or t.numel() < 2:
            raise ValueError(f"{name} must be (c + 1,) int64 with c >= 1, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if qoff.shape != coff.shape:
        raise ValueError(f"qoff and coff differ in length: "
                         f"{tuple(qoff.shape)} and {tuple(coff.shape)}")
    nq, d = Xq.shape
    c = qoff.numel() - 1
    lib = _build.library()
    rows = _build.KNN_BLOCK_ROWS
    blocks = torch.div(qoff[1:] - qoff[:-1] + rows - 1, rows,
                       rounding_mode="floor")
    boff = torch.cat([blocks.new_zeros(1), torch.cumsum(blocks, 0)]).to(
        torch.int32)
    nblocks = int(boff[-1])
    aq = ac = None
    if metric != "manhattan":
        aq = metric_aux_cuda(Xq, metric=metric)
        ac = metric_aux_cuda(Xc, metric=metric)
    dist = torch.empty((nq, k), dtype=torch.float32, device=Xq.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=Xq.device)
    err = lib.repro_knn_topk_segmented(
        Xq.data_ptr(), Xc.data_ptr(), 0 if aq is None else aq.data_ptr(),
        0 if ac is None else ac.data_ptr(), qid.data_ptr(), cid.data_ptr(),
        qoff.data_ptr(), coff.data_ptr(), boff.data_ptr(), c, nblocks, d, k,
        _KINDS[metric], dist.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_graph_segmented")
    _build.LAUNCHES["knn_graph_segmented"] += 1
    return dist, idx


def knn_graph_batch_cuda(X: torch.Tensor, *, k: int,
                         metric: str = "euclidean"):
    """The exact kNN graph of each lane of a stack, on the card, in one
    launch (one aux pre-pass over all b·n rows).  Lane z runs the code of
    ``knn_topk_cuda(X[z], X[z], ids, ids)`` with ids = 0..n-1, so its lists
    are that call's bits.

    Args:
      X: (b, n, d) contiguous float32 CUDA tensor, 1 <= b <= ``MAX_LANES``.
      k: neighbours per point, 1 <= k <= min(``MAX_K``, n - 1).
      metric: one of ``kernels.ref.METRICS`` (gram form).

    Returns:
      (dist (b, n, k) f32, idx (b, n, k) int64): per lane ascending by
      (value, id), lane-local ids, a point never its own neighbour.
    """
    ref.check_metric(metric)
    check_cuda(X, "X")
    if X.dtype != torch.float32 or X.dim() != 3 or 0 in X.shape:
        raise ValueError(f"want a non-empty (b, n, d) float32 X, got "
                         f"{X.dtype} {tuple(X.shape)}")
    b, n, d = X.shape
    check_lanes(b)
    if not 1 <= k <= min(MAX_K, n - 1):
        raise ValueError(f"the kNN kernel keeps 1 <= k <= min({MAX_K}, n-1) "
                         f"= {min(MAX_K, n - 1)} neighbours, got k={k}")
    aux = None if metric == "manhattan" else metric_aux_cuda(X,
                                                             metric=metric)
    ids = torch.arange(n, device=X.device)
    dist = torch.empty((b, n, k), dtype=torch.float32, device=X.device)
    idx = torch.empty((b, n, k), dtype=torch.int64, device=X.device)
    err = _build.library().repro_knn_topk_batch(
        X.data_ptr(), 0 if aux is None else aux.data_ptr(), ids.data_ptr(),
        b, n, d, k, _KINDS[metric], dist.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_graph_batch")
    _build.LAUNCHES["knn_graph_batch"] += 1
    return dist, idx


def knn_topk_blocked(Xq: torch.Tensor, Xc: torch.Tensor, qid: torch.Tensor,
                     cid: torch.Tensor, *, k: int, metric: str = "euclidean",
                     rows: int = 2048, cols: int = 8192):
    """The same function for any k: dissimilarity tiles merged into a
    running list by stable sorts — the reference's ``knn_graph_blocked``.

    Each (``rows``, ``cols``) tile comes from the ``pairwise_dist`` kernel
    on the card (``ref.pairwise_dissim_ref`` for CPU tensors), is masked as
    the kernel masks, and is merged with the running (value, id) list by
    ``ref.lex_smallest``; ties keep the lower id, so on the same tile
    values the lists equal the kNN kernel's.  No tile exceeds (rows, cols)
    and nothing (nq, nc) is formed.

    Returns:
      (dist (nq, k) f32, idx (nq, k) int64), as ``knn_topk_cuda``.
    """
    ref.check_metric(metric)
    tile = pairwise_dist_cuda if Xq.is_cuda else ref.pairwise_dissim_ref
    out_d, out_i = [], []
    for r0 in range(0, Xq.shape[0], rows):
        xq, q = Xq[r0:r0 + rows], qid[r0:r0 + rows]
        best_v = torch.full((xq.shape[0], 0), torch.inf, device=Xq.device)
        best_i = torch.full((xq.shape[0], 0), ref.NO_ID, dtype=torch.int64,
                            device=Xq.device)
        for c0 in range(0, Xc.shape[0], cols):
            v, i = ref.mask_candidates(tile(xq, Xc[c0:c0 + cols],
                                            metric=metric),
                                       q, cid[c0:c0 + cols])
            best_v, best_i = ref.lex_smallest(torch.cat([best_v, v], 1),
                                              torch.cat([best_i, i], 1), k)
        best_v, best_i = ref.finish_topk(best_v, best_i)
        out_d.append(best_v)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)

"""Plain PyTorch versions of the port's kernels.

Written straight from ``repro/kernels/ref.py``: the same formulas, on
tensors.  ``kernels/ops.py`` takes them for CPU tensors; ``chip_smoke.py``
holds each CUDA kernel against them on the card.  A CUDA tensor on the
library's main path never comes here.  The batched versions (``*_batch_ref``)
are the single versions stacked lane by lane, as the reference vmaps its
refs; ``masked_argmin_ref`` takes a leading axis as it is.

Metric support: VAT is defined on an arbitrary pairwise *dissimilarity*
matrix, so the distance versions are metric-dispatched.  ``METRICS`` is the
tuple of computable metrics; ``"precomputed"`` (the caller hands the
matrix in) is an API-layer concept and never reaches this module.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.numerics.condition import check_form

#: Metrics every pairwise path (plain version and CUDA tile) implements.
METRICS = ("euclidean", "sqeuclidean", "manhattan", "cosine")


@contextlib.contextmanager
def full_f32():
    """Run the block's f32 matmuls in full f32 (no TF32), whatever the
    caller set for the process, and restore the caller's setting after.

    Uses ``torch.backends.cuda.matmul.fp32_precision`` where torch has it
    (mixing it with the legacy ``allow_tf32`` flag makes torch raise),
    else ``allow_tf32``.
    """
    m = torch.backends.cuda.matmul
    attr, off = (("fp32_precision", "ieee") if hasattr(m, "fp32_precision")
                 else ("allow_tf32", False))
    saved = getattr(m, attr)
    setattr(m, attr, off)
    try:
        yield
    finally:
        setattr(m, attr, saved)


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


def pairwise_dissim_batch_ref(X: torch.Tensor, *, metric: str = "euclidean",
                              form: str = "gram") -> torch.Tensor:
    """(b, n, n) f32 self-dissimilarity matrices of a (b, n, d) stack: the
    plain version of ``pairwise_dist_batch``, lane by lane (diagonals as
    computed; ``ops.pairwise_dist_batch`` writes the exact zeros)."""
    return torch.stack([pairwise_dissim_ref(x, metric=metric, form=form)
                        for x in X])


def metric_aux_ref(X: torch.Tensor, *, metric: str = "euclidean"
                   ) -> torch.Tensor:
    """Per-point auxiliary vector the Gram-form pivot row needs.

    Args:
      X: (n, d) float — data points ((b, n, d) gives (b, n), row-wise).
      metric: one of ``METRICS``.

    Returns:
      (n,) float32 — squared norms for euclidean/sqeuclidean (under either
      form: the pruning slack of the persistent engine reads ``max(aux)``),
      norms for cosine, zeros for manhattan.
    """
    check_metric(metric)
    Xf = X.float()
    if metric in ("euclidean", "sqeuclidean"):
        return torch.sum(Xf * Xf, dim=-1)
    if metric == "cosine":
        return torch.sqrt(torch.sum(Xf * Xf, dim=-1))
    return torch.zeros(Xf.shape[:-1], dtype=torch.float32, device=X.device)


def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Entry (or row) i of t for an index tensor i of one element, without
    a host sync (indexing with a 0-d tensor reads it on the host)."""
    return t.index_select(0, i.view(1))[0]


def _as_index(q, device) -> torch.Tensor:
    """A vertex index (int or integer tensor) as a 1-element int64 tensor."""
    return torch.as_tensor(q, dtype=torch.int64, device=device).view(1)


#: Fewest rows ``_cross`` hands the matrix product: below it torch's CPU
#: product takes another code path, with other rounding.
_CROSS_MIN_ROWS = 16


def _cross(Xf: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """(n,) dot products of the rows of Xf with xq, as column 0 of a
    two-column matrix product, never a matrix-vector product.

    On the CPU torch's matrix-vector product rounds a row differently
    depending on how many rows it is given, while its matrix product (from
    ``_CROSS_MIN_ROWS`` rows on, which a shorter X is zero-padded to) gives
    each entry the bits it has in ``Xf @ Yf.T`` of any shape: so a shard's
    rows equal the same rows of the whole X, and a pivot row equals the
    materialized matrix's row (``pairwise_dissim_ref``), bit for bit."""
    n = Xf.shape[0]
    if n < _CROSS_MIN_ROWS:
        Xf = torch.cat([Xf, Xf.new_zeros(_CROSS_MIN_ROWS - n, Xf.shape[1])])
    return (Xf @ torch.stack([xq, xq], dim=1))[:n, 0]


def row_dissim_ref(X: torch.Tensor, x: torch.Tensor, *,
                   metric: str = "euclidean") -> torch.Tensor:
    """Dissimilarity of every row of X to a single point x.

    The O(n) building block of maximin sampling (``core.svat``) and of
    ``core.distributed.dvat``'s recomputed rows: no (n, m) intermediate.
    Differences are taken directly (no Gram trick), the more accurate
    formula, so its values match ``pairwise_dissim_ref``'s column only up
    to f32 rounding: do not mix the two inside one bitwise contract.

    Args:
      X: (n, d) float — data points.
      x: (d,) float — the probe point.
      metric: one of ``METRICS``.

    Returns:
      (n,) float32 dissimilarities.
    """
    check_metric(metric)
    Xf = X.float()
    xf = x.float()
    diff = Xf - xf[None, :]
    if metric == "euclidean":
        return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1),
                                          0.0))
    if metric == "sqeuclidean":
        return torch.sum(diff * diff, dim=-1)
    if metric == "manhattan":
        return torch.sum(torch.abs(diff), dim=-1)
    nx = torch.sqrt(torch.sum(Xf * Xf, dim=-1))
    nq = torch.sqrt(torch.sum(xf * xf))
    denom = torch.clamp_min(nx * nq, 1e-12)
    return torch.clamp(1.0 - _cross(Xf, xf) / denom, 0.0, 2.0)


def pivot_row_from_point_ref(X: torch.Tensor, aux: torch.Tensor,
                             xq: torch.Tensor, auxq: torch.Tensor, *,
                             metric: str = "euclidean",
                             form: str = "gram") -> torch.Tensor:
    """The pivot row when the pivot's point and aux entry are in hand.

    The same decomposition per ``form`` as ``pairwise_dissim_ref``, and
    the same bits for the cross term (``_cross``), so that the sharded
    engine's rows of a shard equal the solo engine's rows of the whole X.

    Args:
      X: (n, d) float — data points (one rank's shard is fine).
      aux: (n,) float32 — ``metric_aux_ref(X, metric=metric)``.
      xq: (d,) float — the pivot point.
      auxq: float32 0-d — the pivot's aux entry.
      metric: one of ``METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      (n,) float32 — dissimilarity of every row of X to xq.
    """
    check_metric(metric)
    check_form(form)
    Xf = X.float()
    xq = xq.float()
    if metric == "manhattan":
        return torch.sum(torch.abs(Xf - xq[None, :]), dim=-1)
    if form == "direct" and metric != "cosine":
        diff = Xf - xq[None, :]
        sq = torch.sum(diff * diff, dim=-1)
        return torch.sqrt(sq) if metric == "euclidean" else sq
    cross = _cross(Xf, xq)
    if metric == "cosine":
        denom = torch.clamp_min(aux * auxq, 1e-12)
        return torch.clamp(1.0 - cross / denom, 0.0, 2.0)
    sq = torch.clamp_min(aux + auxq - 2.0 * cross, 0.0)
    return torch.sqrt(sq) if metric == "euclidean" else sq


def pivot_row_ref(X: torch.Tensor, aux: torch.Tensor, q, *,
                  metric: str = "euclidean",
                  form: str = "gram") -> torch.Tensor:
    """Row q of the pairwise dissimilarity matrix, never materializing it:
    ``pivot_row_from_point_ref`` with the pivot gathered from X.

    Args:
      X: (n, d) float — data points.
      aux: (n,) float32 — ``metric_aux_ref(X, metric=metric)``.
      q: the pivot row index (int or integer tensor; a tensor stays on its
        device, so no host sync).
      metric: one of ``METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      (n,) float32 — dissimilarity of every point to point q; the
      self-entry [q] is computed, not forced to zero.
    """
    qi = _as_index(q, X.device)
    return pivot_row_from_point_ref(X, aux, take(X.float(), qi),
                                    take(aux, qi), metric=metric, form=form)


#: "No distance folded yet" sentinel of the persistent engine's in-band
#: frontier (+inf = selected): the largest finite f32, so any real
#: dissimilarity folds below it.
UNSEEN = float(torch.finfo(torch.float32).max)


def prim_persist_ref(X: torch.Tensor, aux: torch.Tensor, i0, *,
                     metric: str = "euclidean", form: str = "gram"):
    """The whole Prim traversal, eager: the persistent engine's plain
    version.

    Selected lanes live in-band as ``mind = +inf``; unvisited lanes start
    at ``UNSEEN``.  Each step folds the pivot's row into every lane that is
    not +inf, takes the minimum and its first index (``torch.argmin``
    returns the first minimal index), and marks the winner +inf.

    Args:
      X: (n, d) float — data points.
      aux: (n,) float32 — ``metric_aux_ref`` of X.
      i0: the seed vertex (int or integer tensor).
      metric: one of ``METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      (order (n,) int64, edges (n,) float32) — the VAT visit order and each
      visit's MST edge weight (edges[0] = 0).
    """
    check_metric(metric)
    n = X.shape[0]
    dev = X.device
    q = _as_index(i0, dev)
    mind = torch.full((n,), UNSEEN, dtype=torch.float32, device=dev)
    mind.index_fill_(0, q, torch.inf)
    order = torch.zeros(n, dtype=torch.int64, device=dev)
    order[0:1] = q
    edges = torch.zeros(n, dtype=torch.float32, device=dev)
    for t in range(1, n):
        row = pivot_row_ref(X, aux, q, metric=metric, form=form)
        mind = torch.where(torch.isinf(mind), torch.inf,
                           torch.minimum(mind, row))
        q = torch.argmin(mind).view(1)
        edges[t:t + 1] = mind.index_select(0, q)
        mind.index_fill_(0, q, torch.inf)
        order[t:t + 1] = q
    return order, edges


def prim_stream_step_ref(X: torch.Tensor, aux: torch.Tensor, q,
                         mind: torch.Tensor, selected: torch.Tensor, *,
                         metric: str = "euclidean", form: str = "gram"):
    """One matrix-free Prim step: fold pivot q's row into the frontier,
    then the masked first-index argmin over the updated frontier.

    Args:
      X: (n, d) float — data points.
      aux: (n,) float32 — ``metric_aux_ref`` of X.
      q: the pivot the previous step selected (int or integer tensor).
      mind: (n,) float32 — frontier before folding in q's row.
      selected: (n,) bool — True lanes are already visited (q included).
      metric: one of ``METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      (new_mind (n,) f32, edge f32 0-d, next int64 0-d).
    """
    row = pivot_row_ref(X, aux, q, metric=metric, form=form)
    new_mind = torch.minimum(mind, row)
    edge, nxt = masked_argmin_ref(new_mind, selected)
    return new_mind, edge, nxt


def prim_stream_record_ref(X: torch.Tensor, aux: torch.Tensor,
                           mind: torch.Tensor, selected: torch.Tensor,
                           order: torch.Tensor, edges: torch.Tensor, t: int,
                           *, metric: str = "euclidean", form: str = "gram"
                           ) -> None:
    """Step t of the stepwise engine, recorded in place: the plain version
    of ``prim_stream.StreamRecord``.

    The pivot is ``order[t - 1]``; ``prim_stream_step_ref`` folds its row
    and takes the masked first-index minimum, which becomes ``order[t]``
    and ``edges[t]`` and is marked in ``selected``; ``mind`` takes the
    folded frontier.  A (b, n, d) stack (aux, mind, selected, order, edges
    (b, n)) steps every lane.

    Args:
      X: (n, d) float — data points; aux (n,) its ``metric_aux_ref``.
      mind: (n,) float32 — the frontier, updated in place.
      selected: (n,) bool — the visited lanes, updated in place.
      order, edges: (n,) int64 and float32 — the traversal so far.
      t: 1 <= t < n.
      metric: one of ``METRICS``.
      form: "gram" (default) or "direct".
    """
    if X.dim() == 3:
        for z in range(X.shape[0]):
            prim_stream_record_ref(X[z], aux[z], mind[z], selected[z],
                                   order[z], edges[z], t, metric=metric,
                                   form=form)
        return
    new_mind, edge, nxt = prim_stream_step_ref(
        X, aux, order[t - 1:t], mind, selected, metric=metric, form=form)
    mind.copy_(new_mind)
    order[t:t + 1] = nxt.view(1)
    edges[t:t + 1] = edge.view(1)
    selected.index_fill_(0, nxt.view(1), True)


def prim_frontier_step_ref(X: torch.Tensor, aux: torch.Tensor,
                           xq: torch.Tensor, auxq: torch.Tensor,
                           mind: torch.Tensor, *, metric: str = "euclidean",
                           form: str = "gram"):
    """Fused frontier fold and argmin with the pivot passed by value.

    The per-rank body of ``core.distributed.vat_matrix_free_sharded``.
    Selected and padded lanes are carried in-band as ``mind = +inf``: the
    fold keeps them +inf (``min(+inf, row)`` would revive them), so no
    separate mask exists.

    Args:
      X: (n, d) float — local points.
      aux: (n,) float32 — ``metric_aux_ref`` of X.
      xq: (d,) float — the pivot point.
      auxq: float32 0-d — the pivot's aux entry.
      mind: (n,) float32 — in-band frontier.
      metric: one of ``METRICS``.
      form: "gram" (default) or "direct".

    Returns:
      (new_mind (n,) f32, value f32 0-d, idx int64 0-d) — the folded
      frontier and its minimum, the first index among equal minima.
    """
    row = pivot_row_from_point_ref(X, aux, xq, auxq, metric=metric,
                                   form=form)
    new_mind = torch.where(torch.isinf(mind), torch.inf,
                           torch.minimum(mind, row))
    idx = torch.argmin(new_mind)
    return new_mind, take(new_mind, idx), idx


#: Words of a frontier slot before the point: the packed key (two f32
#: words holding one int64), the value, the aux entry.
SLOT_HEAD = 4


def slot_width(d: int) -> int:
    """f32 words of one rank's slot in the sharded engine's all-gather:
    ``SLOT_HEAD`` words, then the point, padded to a multiple of four words
    so that every slot of a gathered table starts 16-byte aligned."""
    return SLOT_HEAD + 4 * -(-d // 4)


def signed_key(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The int64 key whose order is (value, idx) lexicographic order: the
    f32 bits made monotone as a signed int32 (-0.0 folded onto +0.0) in the
    high word, the index in the low word.  ``csrc/argmin_key.cuh``'s
    ``pack_key`` with its top bit flipped, so that torch's signed int64
    min is the kernel's unsigned min."""
    v = torch.where(value == 0, 0.0, value.float())
    bits = v.view(torch.int32)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return mono * (1 << 32) + idx.to(torch.int64)


def make_slot(key_value: torch.Tensor, gid: torch.Tensor,
              value: torch.Tensor, auxv: torch.Tensor, x: torch.Tensor,
              width: int) -> torch.Tensor:
    """One rank's (width,) f32 slot: ``signed_key(key_value, gid)``, then
    value, aux entry and the point x, zero-padded."""
    slot = torch.zeros(width, dtype=torch.float32, device=x.device)
    slot[:2] = signed_key(key_value, gid).view(1).view(torch.float32)
    slot[2] = value
    slot[3] = auxv
    slot[SLOT_HEAD:SLOT_HEAD + x.shape[0]] = x
    return slot


def slot_keys(table: torch.Tensor) -> torch.Tensor:
    """(P,) int64 keys of a (P, width) table of slots."""
    return table[:, :2].contiguous().view(torch.int64)[:, 0]


def slot_id(slot: torch.Tensor) -> torch.Tensor:
    """The global vertex id a slot carries (the key's low word), 0-d."""
    return slot[:2].contiguous().view(torch.int64)[0] & 0xFFFFFFFF


def prim_frontier_round_ref(X: torch.Tensor, aux: torch.Tensor,
                            table: torch.Tensor, mind: torch.Tensor,
                            order: torch.Tensor, edges: torch.Tensor, t: int,
                            *, offset: int, metric: str = "euclidean",
                            form: str = "gram"):
    """One step of the sharded engine on one rank: the plain version of
    ``prim_frontier_step_cuda``.

    The pivot is the slot of ``table`` (the all-gathered slots of the last
    step) with the least key; its id and value are recorded as
    ``order[t]`` and ``edges[t]``; its lane is closed (+inf) on the rank
    that owns it; its row is folded in by ``prim_frontier_step_ref``; and
    the local minimum, with its global id ``offset + idx``, its aux entry
    and its point, becomes this rank's new slot.

    Args:
      X: (n, d) float32 — the rank's shard; aux (n,) its aux vector.
      table: (P, slot_width(d)) float32 — the gathered slots.
      mind: (n,) float32 — the in-band frontier.
      order, edges: (N,) int64 and float32 — the traversal being recorded.
      t: the position the pivot takes in the order.
      offset: the global id of the shard's first lane.

    Returns:
      (new_mind (n,) f32, slot (width,) f32).
    """
    pivot = take(table, torch.argmin(slot_keys(table)))
    q = slot_id(pivot)
    order[t] = q
    edges[t] = pivot[2]
    ids = torch.arange(X.shape[0], device=X.device) + offset
    mind = torch.where(ids == q, torch.inf, mind)
    d = X.shape[1]
    new_mind, value, idx = prim_frontier_step_ref(
        X, aux, pivot[SLOT_HEAD:SLOT_HEAD + d], pivot[3], mind,
        metric=metric, form=form)
    return new_mind, make_slot(value, idx + offset, value, take(aux, idx),
                               take(X, idx).float(), table.shape[1])


def prim_stream_step_batch_ref(X: torch.Tensor, aux: torch.Tensor,
                               q: torch.Tensor, mind: torch.Tensor,
                               selected: torch.Tensor, *,
                               metric: str = "euclidean",
                               form: str = "gram"):
    """``prim_stream_step_ref`` of each lane of a (b, n, d) stack: aux,
    mind, selected (b, n), q (b,).  Returns (new_mind (b, n) f32, edge (b,)
    f32, next (b,) int64)."""
    steps = [prim_stream_step_ref(X[z], aux[z], q[z], mind[z], selected[z],
                                  metric=metric, form=form)
             for z in range(X.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*steps))


def prim_persist_batch_ref(X: torch.Tensor, aux: torch.Tensor,
                           i0: torch.Tensor, *, metric: str = "euclidean",
                           form: str = "gram"):
    """``prim_persist_ref`` of each lane of a (b, n, d) stack from its seed
    i0[z]: (order (b, n) int64, edges (b, n) f32)."""
    runs = [prim_persist_ref(X[z], aux[z], i0[z], metric=metric, form=form)
            for z in range(X.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*runs))


def masked_argmin_ref(vals: torch.Tensor, mask: torch.Tensor):
    """(min value, argmin index) of vals where mask is False.

    Args:
      vals: (n,) float — candidate values (Prim frontier distances); a
        (b, n) stack is reduced along its last axis, row by row.
      mask: bool, vals' shape — True means "excluded" (already selected).

    Returns:
      (min value f32, argmin index int64) over unmasked lanes — 0-d for
      one vector, (b,) for a stack — first-index tie-breaking
      (``torch.argmin`` returns the first minimal index); a fully masked
      row gives (+inf, 0).
    """
    masked = torch.where(mask, torch.inf, vals.float())
    idx = torch.argmin(masked, dim=-1)
    return masked.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


def vat_prim_order_ref(R: torch.Tensor, i0: torch.Tensor, *,
                       argmin=None) -> torch.Tensor:
    """Prim's VAT order of R from seed i0 — the plain version of the
    one-launch Prim kernel, and the CPU path.

    A loop over device tensors: each step one masked argmin of the
    frontier, the order write, the selection mark, the pivot row's gather
    and the min fold.  The selected vertex stays a device tensor, so no
    step waits on the host.  A (b, n, n) stack runs every lane in the same
    loop, one op over all lanes a step; each lane gets its own order bit
    for bit (a min and an argmin involve no rounding).

    Args:
      R: (n, n) or (b, n, n) float — dissimilarity matrix or stack.
      i0: the seed (one element) or seeds (b,), int64.
      argmin: the masked argmin of each step, ``(vals (b, n), mask) ->
        (min (b,), index (b,))``; None means ``masked_argmin_ref``.

    Returns:
      (n,) int64 order, or (b, n) for a stack.
    """
    argmin = masked_argmin_ref if argmin is None else argmin
    Rb = R[None] if R.dim() == 2 else R
    b, n, _ = Rb.shape
    i0 = i0.reshape(b)
    order = torch.empty((b, n), dtype=torch.int64, device=R.device)
    order[:, 0] = i0
    selected = torch.zeros((b, n), dtype=torch.bool, device=R.device)
    selected.scatter_(1, i0.view(b, 1), True)
    mind = torch.gather(Rb, 1, i0.view(b, 1, 1).expand(b, 1, n))[:, 0]
    for t in range(1, n):
        _, q = argmin(mind, selected)
        order[:, t] = q
        selected.scatter_(1, q.view(b, 1), True)
        torch.minimum(mind, torch.gather(
            Rb, 1, q.view(b, 1, 1).expand(b, 1, n))[:, 0], out=mind)
    return order if R.dim() == 3 else order[0]


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


# The range route of the iVAT transform, stage by stage (the plain versions
# of ``csrc/ivat_update.cu``'s three range-route kernels).  A lane of the
# recurrence above is the path maximum over the tree of edges (r, j_r);
# when no i in (j_r, r) has w_i > w_r for any r -- which every Prim order
# gives -- it is the range maximum D'[a, c] = max(+0, w_{a+1}, .., w_c).

#: Elements one block of the plain stages holds at once (b * rows * n).
_RANGE_BLOCK_ELEMS = 1 << 24


def _row_block(b: int, n: int) -> int:
    return max(1, _RANGE_BLOCK_ELEMS // max(1, b * n))


def _lanes(t: torch.Tensor, matrix: bool) -> torch.Tensor:
    """A lone matrix (or vector) as a stack of one lane."""
    return t[None] if t.dim() == (2 if matrix else 1) else t


def ivat_parents_ref(rstar: torch.Tensor):
    """Stage 1: each row's parent in the tree and its edge weight.

    Args:
      rstar: (n, n) or (b, n, n) float32 VAT-ordered matrix or stack.

    Returns:
      (j, w): int32 and float32 of shape (n,) or (b, n).  For r >= 1, j[r]
      is the first-index argmin over k < r of rstar[r, k] in the order of
      ``signed_key`` (the kernels' packed keys: -0.0 ties +0.0, a positive
      NaN above +inf), and w[r] is rstar[r, j[r]] with its own bits; row 0
      has j = 0 and w = -inf.
    """
    R = _lanes(rstar.float(), True)
    b, n, _ = R.shape
    j = torch.zeros((b, n), dtype=torch.int32, device=R.device)
    w = torch.full((b, n), -torch.inf, dtype=torch.float32, device=R.device)
    col = torch.arange(n, device=R.device)
    step = _row_block(b, n)
    for r0 in range(1, n, step):
        rows = R[:, r0:r0 + step]
        r = torch.arange(r0, r0 + rows.shape[1], device=R.device)
        keys = torch.where(col[None, :] < r[:, None], signed_key(rows, col),
                           torch.iinfo(torch.int64).max)
        jj = torch.argmin(keys, dim=-1)
        j[:, r0:r0 + rows.shape[1]] = jj.to(torch.int32)
        w[:, r0:r0 + rows.shape[1]] = torch.gather(rows, 2,
                                                   jj[..., None])[..., 0]
    return (j, w) if rstar.dim() == 3 else (j[0], w[0])


def ivat_route_ref(j: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stage 2: whether each lane may take the range route.

    A lane passes when no w[r] (r >= 1) is NaN and, for every r >= 2, no i
    with j[r] < i < r has ``not (w[i] <= w[r])``; the test is written out
    over each row's whole range, with no table.

    Returns:
      bool, 0-d for (n,) inputs or (b,) for (b, n).
    """
    J = _lanes(j, False).to(torch.int64)
    W = _lanes(w, False)
    b, n = W.shape
    ok = ~torch.isnan(W[:, 1:]).any(dim=1)
    i = torch.arange(n, device=W.device)
    step = _row_block(b, n)
    for r0 in range(2, n, step):
        r = torch.arange(r0, min(n, r0 + step), device=W.device)
        inside = (i[None, None, :] > J[:, r0:r0 + r.shape[0], None]) \
            & (i[None, None, :] < r[None, :, None])
        above = ~(W[:, None, :] <= W[:, r0:r0 + r.shape[0], None])
        ok &= ~(inside & above).any(dim=(1, 2))
    return ok if w.dim() == 2 else ok[0]


def ivat_range_ref(w: torch.Tensor) -> torch.Tensor:
    """Stage 3: the iVAT image as a range maximum of the weights.

    D'[a, c] = D'[c, a] = max(+0, w[a+1], .., w[c]) for a < c, and a zero
    diagonal; every zero is +0.0.  The upper triangle is a running maximum
    along each row (rows in blocks), then mirrored.

    Returns:
      float32 (n, n) for an (n,) w, (b, n, n) for (b, n).
    """
    W = _lanes(w.float(), False)
    b, n = W.shape
    upper = torch.zeros((b, n, n), dtype=torch.float32, device=W.device)
    i = torch.arange(n, device=W.device)
    step = _row_block(b, n)
    for a0 in range(0, n, step):
        a = torch.arange(a0, min(n, a0 + step), device=W.device)
        after = i[None, :] > a[:, None]
        run = torch.cummax(torch.where(after, W[:, None, :], -torch.inf),
                           dim=-1).values
        upper[:, a0:a0 + a.shape[0]] = torch.where(after & (run > 0), run,
                                                   0.0)
    D = upper + upper.transpose(1, 2)
    return D if w.dim() == 2 else D[0]


#: The id of an empty top-k slot while lists are merged: it sorts after
#: every real candidate id, so a masked candidate never displaces one.
NO_ID = torch.iinfo(torch.int64).max


def lex_smallest(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest (value, id) pairs of each row, lexicographically.

    A stable sort by id, then a stable sort by value: ties in value keep
    the lower id first, whatever order the columns came in.  Rows with
    fewer than k columns are padded with (+inf, ``NO_ID``).

    Args:
      vals: (r, c) float32 — candidate values (+inf for masked ones).
      ids: (r, c) int64 — candidate ids, ``NO_ID`` for masked ones.
      k: entries to keep per row.

    Returns:
      (vals (r, k) f32, ids (r, k) int64), ascending by (value, id), with
      ``NO_ID`` left in empty slots (``finish_topk`` turns them into -1).
    """
    r, c = vals.shape
    if c < k:
        vals = torch.cat([vals, vals.new_full((r, k - c), torch.inf)], 1)
        ids = torch.cat([ids, ids.new_full((r, k - c), NO_ID)], 1)
    o = torch.argsort(ids, dim=1, stable=True)
    vals, ids = vals.gather(1, o), ids.gather(1, o)
    o = torch.argsort(vals, dim=1, stable=True)[:, :k]
    return vals.gather(1, o), ids.gather(1, o)


def finish_topk(vals: torch.Tensor, ids: torch.Tensor):
    """Empty slots of a ``lex_smallest`` list become (+inf, -1)."""
    empty = ids == NO_ID
    return vals.masked_fill(empty, torch.inf), ids.masked_fill(empty, -1)


def mask_candidates(D: torch.Tensor, qid: torch.Tensor, cid: torch.Tensor):
    """(values, ids) of a (r, c) dissimilarity block for ``lex_smallest``:
    a candidate with ``cid < 0``, or with ``cid == qid`` of its row, is
    masked to (+inf, ``NO_ID``)."""
    qid = qid.to(torch.int64)
    cid = cid.to(torch.int64)
    bad = (cid[None, :] < 0) | (cid[None, :] == qid[:, None])
    ids = torch.where(bad, NO_ID, cid[None, :].expand(D.shape[0], -1))
    return D.float().masked_fill(bad, torch.inf), ids


def topk_from_dissim(D: torch.Tensor, qid: torch.Tensor, cid: torch.Tensor,
                     k: int):
    """The k nearest candidates of each row of a dissimilarity block.

    Args:
      D: (r, c) float — dissimilarity of query row i to candidate j.
      qid: (r,) integer — the queries' ids (a sentinel such as -1 for
        queries that are no candidate).
      cid: (c,) integer — the candidates' ids; ``cid < 0`` marks padding.
      k: neighbours per row.

    Returns:
      (dist (r, k) f32, idx (r, k) int64): ascending by (value, candidate
      id); masked candidates never appear, and a slot no valid candidate
      fills holds (+inf, -1).
    """
    return finish_topk(*lex_smallest(*mask_candidates(D, qid, cid), k))


#: Query rows per block of ``knn_topk_ref``: bounds its dissimilarity block
#: to (2,048, nc) f32.
KNN_QUERY_BLOCK = 2048


def knn_topk_ref(Xq: torch.Tensor, Xc: torch.Tensor, qid: torch.Tensor,
                 cid: torch.Tensor, *, k: int, metric: str = "euclidean"):
    """k nearest candidates of every query — the kNN kernel's plain version.

    The gram-form dissimilarity (``pairwise_dissim_ref``) of each query to
    every candidate, masking and selection by ``topk_from_dissim``.  Every
    row depends on its own query only, so queries go in blocks of
    ``KNN_QUERY_BLOCK`` rows and no larger block of the (nq, nc) matrix
    exists.
    It also stands in for the reference's per-cell ``_cell_topk``
    (``repro/core/approx_mst.py``).

    Args:
      Xq: (nq, d) float — query points.
      Xc: (nc, d) float — candidate points.
      qid: (nq,) integer — query ids.
      cid: (nc,) integer — candidate ids; < 0 marks padding.
      k: neighbours per query (k > nc leaves (+inf, -1) slots).
      metric: one of ``METRICS``.

    Returns:
      (dist (nq, k) f32, idx (nq, k) int64), ascending by (value, id).
    """
    check_metric(metric)
    b = KNN_QUERY_BLOCK
    parts = [topk_from_dissim(
        pairwise_dissim_ref(Xq[r0:r0 + b], Xc, metric=metric),
        qid[r0:r0 + b], cid, k) for r0 in range(0, Xq.shape[0], b)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def knn_topk_segmented_ref(Xq: torch.Tensor, Xc: torch.Tensor,
                           qid: torch.Tensor, cid: torch.Tensor,
                           qoff: torch.Tensor, coff: torch.Tensor, *, k: int,
                           metric: str = "euclidean", topk=None):
    """``knn_topk_ref`` of every segment — the segmented kernel's plain
    version: segment g is its queries ``qoff[g]:qoff[g+1]`` against its
    candidates ``coff[g]:coff[g+1]``; a segment with no candidates leaves
    (+inf, -1) in every slot of its rows.  ``topk`` replaces
    ``knn_topk_ref`` as the per-segment call (the card's blocked route for
    k > ``MAX_K`` passes ``knn_topk_blocked``).

    Returns:
      (dist (Q, k) f32, idx (Q, k) int64), Q = ``qoff[-1]``.
    """
    check_metric(metric)
    topk = knn_topk_ref if topk is None else topk
    qo, co = qoff.tolist(), coff.tolist()
    dist = torch.full((qo[-1], k), torch.inf, device=Xq.device)
    idx = torch.full((qo[-1], k), -1, dtype=torch.int64, device=Xq.device)
    for g in range(len(qo) - 1):
        q0, q1, c0, c1 = qo[g], qo[g + 1], co[g], co[g + 1]
        if q1 > q0 and c1 > c0:
            dist[q0:q1], idx[q0:q1] = topk(
                Xq[q0:q1], Xc[c0:c1], qid[q0:q1], cid[c0:c1], k=k,
                metric=metric)
    return dist, idx


def knn_graph_ref(X: torch.Tensor, *, k: int, metric: str = "euclidean"):
    """k nearest neighbours of every point — the materializing oracle.

    The gram-form matrix of ``pairwise_dissim_ref`` with the diagonal at
    +inf, the k smallest per row ascending by (value, index): the lower
    index wins a tie, the contract every kNN path of the port shares
    (``torch.topk``'s tie order is unspecified, so stable sorts are used).

    Args:
      X: (n, d) float — data points.
      k: neighbours per point; 1 <= k <= n - 1.
      metric: one of ``METRICS``.

    Returns:
      (dist (n, k) f32 ascending per row, idx (n, k) int64) — idx[i, 0] is
      i's nearest neighbour; no point is its own neighbour.
    """
    n = X.shape[0]
    if not 1 <= k <= n - 1:
        raise ValueError(f"k must satisfy 1 <= k <= n-1 = {n - 1}, got {k}")
    ids = torch.arange(n, device=X.device)
    return knn_topk_ref(X, X, ids, ids, k=k, metric=metric)


def knn_graph_batch_ref(X: torch.Tensor, *, k: int,
                        metric: str = "euclidean"):
    """``knn_graph_ref`` of each lane of a (b, n, d) stack: (dist (b, n, k)
    f32, idx (b, n, k) int64), lane-local ids."""
    graphs = [knn_graph_ref(x, k=k, metric=metric) for x in X]
    return (torch.stack([g[0] for g in graphs]),
            torch.stack([g[1] for g in graphs]))

"""Distributed VAT on ``torch.distributed``: the engines that shard the
points over the ranks of a process group.

* ``pairwise_dist_sharded``: the (n, n) matrix by row blocks, one block a
  rank.
* ``dvat``: matrix-free distributed VAT.  Each rank keeps its rows' Prim
  frontier and recomputes the distance row of each new vertex from its
  points (``kernels.ref.row_dissim_ref``); one all-gather a step picks the
  next vertex and carries its point to every rank.
* ``vat_matrix_free_sharded``: the flashvat rung's exact matrix-free engine
  over the ranks.  The seed is the solo streamed row-max scan restricted to
  the rank's rows; each step runs the frontier kernel
  (``kernels.ops.prim_frontier_step``) on the rank's shard, then one
  all-gather of every rank's slot — [key, value, aux, point] — from which
  every rank takes the next pivot (the step built once a traversal:
  ``kernels.ops.prim_frontier_stepper``).  Orders and edges equal
  ``core.vat.vat_matrix_free``'s bit for bit on any number of ranks.

The reference's ``Mesh`` is a process group here: every function takes
``group`` (None is the default group) and the full X on every rank, as the
reference takes its global array, and works on the rank's contiguous row
block.  Each rank's tensors live on its own device (``cuda:LOCAL_RANK``
under NCCL, the CPU under gloo); the caller initializes the group
(``torchrun`` or ``torch.multiprocessing.spawn``, then
``init_process_group``).  Results are replicated on every rank.  Without an
initialized group the functions raise ``RuntimeError``.

Every collective is an all-gather of raw bits: a broadcast would need the
owner rank on the host (a sync every step), and the reference's sum of a
zero-padded row turns a -0.0 coordinate into +0.0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.vat import FlashVATResult, _seed_rowmax
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


class DVATResult(NamedTuple):
    order: torch.Tensor  # (n,) int64 VAT permutation (replicated)


def _world(group) -> tuple[int, int]:
    """(world size, rank) of ``group``; RuntimeError when no process group
    is initialized."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the sharded engines need an initialized torch.distributed "
            "process group (torchrun or torch.multiprocessing.spawn, then "
            "init_process_group: gloo on the CPU, NCCL on the card); none is")
    return dist.get_world_size(group), dist.get_rank(group)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Every rank's ``inp`` into ``out``, rank by rank, bits untouched.
    (``all_gather_into_tensor`` is the call both torch versions the port
    runs on have; newer ones name it ``all_gather_single``.)"""
    dist.all_gather_into_tensor(out, inp, group=group)


def _shard(X: torch.Tensor, P: int, r: int):
    """Rank r's contiguous row block of X padded to P blocks of nl rows:
    (Xl (nl, d) float32, nl, offset); padded rows are zero."""
    n, d = X.shape
    nl = -(-n // P)
    offset = r * nl
    Xl = torch.zeros((nl, d), dtype=torch.float32, device=X.device)
    rows = X[offset:min(n, offset + nl)]
    Xl[:rows.shape[0]] = rows
    return Xl, nl, offset


def _gather_rows(Xl: torch.Tensor, P: int, group) -> torch.Tensor:
    """(P nl, d) — every rank's block, in rank order."""
    Xall = torch.empty((P * Xl.shape[0], Xl.shape[1]), dtype=Xl.dtype,
                       device=Xl.device)
    _all_gather(Xall, Xl, group)
    return Xall


def pairwise_dist_sharded(X: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's row block of the (n, n) distance matrix: rows
    [r n/P, (r + 1) n/P) against every point, X gathered per rank.

    Args:
      X: (n, d) float — the points, the same on every rank; P must divide
        n, as in the reference.
      group: the process group (None: the default group).

    Returns:
      (n/P, n) float32 on X's device.
    """
    P, r = _world(group)
    n = X.shape[0]
    if n % P:
        raise ValueError(f"pairwise_dist_sharded needs n divisible by the "
                         f"world size ({n} % {P} != 0)")
    Xl, _, _ = _shard(X, P, r)
    return kops.pairwise_dist(Xl, _gather_rows(Xl, P, group))


def dvat(X: torch.Tensor, group=None, *, exact_start: bool = True,
         metric: str = "euclidean") -> DVATResult:
    """Matrix-free distributed VAT ordering of X (n, d).

    Each rank owns n/P rows and their frontier; each step every rank
    offers its nearest unselected row, one all-gather of the offers picks
    the global one (the least (value, id), so first-index ties) and carries
    its point, and every rank folds that point's direct-difference row
    (``kernels.ref.row_dissim_ref``) into its frontier.

    Args:
      X: (n, d) float — the points, the same on every rank; P must divide
        n (pad upstream otherwise).
      group: the process group (None: the default group).
      exact_start: start from the row of the largest dissimilarity (one
        (n/P, n) strip of ``kernels.ops.pairwise_dist`` a rank); False
        starts from the point farthest from the mean (the block structure
        is the same; the order may start in another cluster).
      metric: one of ``kernels.ref.METRICS``.

    Returns:
      ``DVATResult`` — order (n,) int64, replicated on every rank.
    """
    kref.check_metric(metric)
    P, r = _world(group)
    n, d = X.shape
    if n % P:
        raise ValueError(f"dvat needs n divisible by the world size "
                         f"({n} % {P} != 0); pad or truncate X first")
    Xl, nl, offset = _shard(X, P, r)
    dev = Xl.device
    if exact_start:
        strip = kops.pairwise_dist(Xl, _gather_rows(Xl, P, group),
                                   metric=metric)              # (nl, n)
        far = torch.amax(strip, dim=1)
        del strip
    else:
        mean = torch.mean(Xl, dim=0)
        dist.all_reduce(mean, group=group)
        far = kref.row_dissim_ref(Xl, mean / P, metric=metric)
    li = torch.argmax(far)
    width = kref.slot_width(d)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # the least key is the largest value, first index among equals
    slot = kref.make_slot(-kref.take(far, li), li + offset, zero, zero,
                          kref.take(Xl, li), width)
    table = torch.empty((P, width), dtype=torch.float32, device=dev)
    _all_gather(table.view(-1), slot, group)
    ids = torch.arange(nl, device=dev) + offset
    mind = torch.full((nl,), torch.inf, dtype=torch.float32, device=dev)
    selected = torch.zeros(nl, dtype=torch.bool, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    for t in range(n):
        pivot = kref.take(table, torch.argmin(kref.slot_keys(table)))
        q = kref.slot_id(pivot)
        order[t] = q
        if t == n - 1:
            break
        selected |= ids == q
        mind = torch.minimum(mind, kref.row_dissim_ref(
            Xl, pivot[kref.SLOT_HEAD:kref.SLOT_HEAD + d], metric=metric))
        masked = torch.where(selected, torch.inf, mind)
        li = torch.argmin(masked)
        low = kref.take(masked, li)
        slot = kref.make_slot(low, li + offset, low, zero,
                              kref.take(Xl, li), width)
        _all_gather(table.view(-1), slot, group)
    return DVATResult(order=order)


def vat_matrix_free_sharded(X: torch.Tensor, group=None, *,
                            metric: str = "euclidean") -> FlashVATResult:
    """Exact matrix-free VAT over the ranks of a process group.

    Rank r owns the contiguous row block [r nl, (r + 1) nl) of X padded to
    P nl rows (nl = ceil(n / P)); padded lanes ride in band as +inf and
    never win.

      * Seed: the rank's rows scanned against an all-gathered copy of the
        points in ``SEED_BLOCK`` blocks (``core.vat._seed_rowmax``, the
        solo scan restricted to the rank's rows: never an (n/P, n) strip),
        the copy freed before the traversal; each rank's slot offers its
        row of largest maximum, and the least key over ranks (value
        negated) is the solo seed, first index among equals.
      * Traversal: n launches of the frontier kernel on the shard
        (``kernels.ops.prim_frontier_step``), each followed (but the last)
        by one all-gather of the ranks' slots; the least-key slot is the
        next pivot, so no step waits on the host.

    Every per-lane formula is the solo engine's restricted to the shard,
    f32 min folds are exact, and first-rank ties over contiguous blocks are
    first-index ties, so the order and edges equal
    ``core.vat.vat_matrix_free``'s bit for bit on the same device.  Memory
    a rank: O(n d / P) for the shard and O(n) for the record, plus the
    gathered O(n d) copy during the seed.  The gram form only, as in the
    reference.

    Args:
      X: (n, d) float — the points, the same on every rank, on the rank's
        device; n need not divide by P.
      group: the process group (None: the default group).
      metric: one of ``kernels.ref.METRICS``.

    Returns:
      ``FlashVATResult`` — order (n,) int64 and edges (n,) float32,
      replicated on every rank.
    """
    kref.check_metric(metric)
    P, r = _world(group)
    n, d = X.shape
    Xl, nl, offset = _shard(X.float(), P, r)
    dev = Xl.device
    aux = kops.metric_aux(Xl, metric=metric)
    ids = torch.arange(nl, device=dev) + offset
    Xall = _gather_rows(Xl, P, group)
    rowmax = _seed_rowmax(Xl, Xall, r0=offset, n=n, metric=metric)
    del Xall
    rowmax = torch.where(ids < n, rowmax, -torch.inf)
    li = torch.argmax(rowmax)
    width = kref.slot_width(d)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    slot = kref.make_slot(-kref.take(rowmax, li), li + offset, zero,
                          kref.take(aux, li), kref.take(Xl, li), width)
    table = torch.empty((P, width), dtype=torch.float32, device=dev)
    _all_gather(table.view(-1), slot, group)
    mind = torch.where(ids < n, kref.UNSEEN, torch.inf)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    edges = torch.empty(n, dtype=torch.float32, device=dev)
    step = kops.prim_frontier_stepper(Xl, aux, table, mind, slot, order,
                                      edges, offset=offset, metric=metric)
    for t in range(n):
        step(t)
        if t < n - 1:
            _all_gather(table.view(-1), slot, group)
    return FlashVATResult(order=order, edges=edges)

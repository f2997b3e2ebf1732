"""CUDA kernel: the whole exact Prim traversal in one launch, lazily pruned,
each traversal spread over a group of CTAs.

The port of ``repro/kernels/prim_persist.py::prim_persist_pallas``, the
flashvat rung's default ("Turbo") engine.  The kernel is
``csrc/prim_persist.cu`` (its opening note gives the schedule, the bound
and the design); this module computes the per-tile pruning geometry in
plain PyTorch (``persist_tile_bounds``) and the pruning slack, asks the
library for the launch plan (``persist_plan``: G CTAs a traversal, whether
their rows fit in shared memory), allocates the state, and launches on the
current stream.  A (b, n, d) stack is one launch of b groups of G CTAs,
each lane with its own tile bounds, slack, state and stats.

The reference's VMEM seam (``persist_supported``, ``persist_state_bytes``,
``PERSIST_VMEM_BUDGET``) is a TPU rule and has no counterpart: the state
lives in global memory, so a CUDA tensor of any n takes the kernel.  Nor is
anything padded in memory (the reference's ``pad_points``): the kernel
masks the ragged last tile itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import (_KINDS, check_cuda,
                                              check_lanes)
from repro_torch.kernels.ref import check_metric
from repro_torch.numerics.condition import _F32_EPS, check_form, lb_slack_ulps

#: Lanes of X per tile.  It sets the number of tiles, and with it how the
#: traversal spreads over a group's CTAs, which tiles a step folds and the
#: kernel's stats; no bit of order or edges.
DEFAULT_BLOCK = 128

#: Relative safety factor on every pruning lower bound (the reference's):
#: the direct-form bound math carries a few ulp of f32 rounding; shrinking
#: it 1e-3 keeps it a true lower bound with ~100x margin.
_LB_MARGIN = 0.999


def persist_tile_bounds(X: torch.Tensor, *, metric: str, block: int):
    """Per-tile (centroid, radius) for the pruning bounds.

    Args:
      X: (n, d) float32 — the points (unpadded).
      metric: one of ``kernels.ref.METRICS``.
      block: tile length; tile T holds lanes [T·block, (T+1)·block) ∩ [0, n).

    Returns:
      (cent (nblk, d) f32, rad (nblk,) f32): each tile's mean point and its
      radius in the bound's geometry — euclidean for euclidean/sqeuclidean,
      L1 for manhattan, +inf for cosine (no triangle inequality, so no
      pruning).  Both in the direct difference form, so their errors are
      relative and ``_LB_MARGIN`` covers them.
    """
    check_metric(metric)
    n, d = X.shape
    nblk = -(-n // block)
    Xf = X.float()
    tiles = torch.nn.functional.pad(Xf, (0, 0, 0, nblk * block - n)).view(
        nblk, block, d)
    real = (torch.arange(nblk * block, device=X.device) < n).view(nblk, block)
    cnt = torch.clamp_min(real.sum(dim=1), 1).float()
    cent = torch.sum(tiles, dim=1) / cnt[:, None]   # padded rows are zeros
    if metric == "cosine":
        rad = torch.full((nblk,), torch.inf, device=X.device)
    else:
        diff = tiles - cent[:, None, :]
        if metric == "manhattan":
            dist = torch.sum(torch.abs(diff), dim=-1)
        else:
            dist = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1),
                                              0.0))
        rad = torch.amax(torch.where(real, dist, -torch.inf), dim=1)
    return cent.contiguous(), torch.clamp_min(rad, 0.0).contiguous()


def persist_plan(b: int, n: int, d: int, *, metric: str = "euclidean",
                 form: str = "gram", block: int = DEFAULT_BLOCK,
                 max_group: int | None = None) -> dict:
    """The kernel's launch plan for b traversals of (n, d) on the current
    card: ``group`` (G, the CTAs of one traversal: the co-resident CTAs the
    occupancy API allows, shared among the b lanes, at most the tile count
    and ``max_group``), ``ctas`` (b·G), ``tiles_per_cta``, ``rows_staged``
    (each CTA's rows and frontier in shared memory), ``smem_bytes`` (the
    dynamic shared memory a CTA) and ``pivot_rows_staged``."""
    out = torch.zeros(5, dtype=torch.int32)
    err = _build.library().repro_prim_persist_plan(
        b, n, d, block, _KINDS[(metric, form)], max_group or 0,
        out.data_ptr())
    _build.check(err, "prim_persist plan")
    group, tpc, staged, smem, pstaged = out.tolist()
    return {"group": group, "ctas": b * group, "tiles_per_cta": tpc,
            "rows_staged": bool(staged), "smem_bytes": smem,
            "pivot_rows_staged": bool(pstaged)}


def prim_persist_cuda(X: torch.Tensor, aux: torch.Tensor, i0: torch.Tensor,
                      *, metric: str = "euclidean", form: str = "gram",
                      block: int = DEFAULT_BLOCK, prune: bool = True,
                      max_group: int | None = None):
    """Exact VAT ordering of X in one launch, on the card.

    Args:
      X: (n, d) contiguous float32 CUDA tensor, n >= 1; or a (b, n, d)
        stack of b datasets, 1 <= b <= ``MAX_LANES``, traversed by b groups
        of CTAs of one launch, lane z exactly as the call on X[z] alone.
      aux: (n,) float32 — ``kernels.ops.metric_aux`` of X ((b, n) for a
        stack; on the card the pairwise kernel's row norms, so rows match
        its matrix bit for bit).
      i0: integer CUDA tensor of one element — the seed vertex ((b,) for a
        stack); the kernel reads it, so nothing waits on the host.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" or "direct" — the tile form; the pruning slack is
        ``lb_slack_ulps(form)·eps·max(aux)`` in squared units, per lane.
      block: tile length (>= 1).
      prune: lazy tile pruning; False folds every live tile every step —
        the same order and edges bit for bit, more work.
      max_group: a cap on G, the CTAs of one traversal (``persist_plan``);
        it changes where the work runs, never a bit of the result.

    Returns:
      (order (n,) int64, edges (n,) f32, stats (4,) int64) — the visit
      order, each visit's MST edge weight (edges[0] = 0), and the work done:
      [tile folds, pivot-row folds, pair evaluations, group barriers],
      where a pair evaluation is one (pivot, unselected lane) dissimilarity.
      The eager schedule folds at most (n - 1)·nblk tiles, pruning fewer;
      both evaluate exactly n·(n - 1)/2 pairs, each lane against every
      earlier pivot once, and make one barrier a step.  None of the four
      depends on G.  A stack gives (b, n), (b, n) and (b, 4).
    """
    check_metric(metric)
    check_form(form)
    for t, name in ((X, "X"), (aux, "aux"), (i0, "i0")):
        check_cuda(t, name)
    if X.dtype != torch.float32 or X.dim() not in (2, 3) or 0 in X.shape:
        raise ValueError(f"want a non-empty (n, d) or (b, n, d) float32 X, "
                         f"got {X.dtype} {tuple(X.shape)}")
    batched = X.dim() == 3
    b = X.shape[0] if batched else 1
    check_lanes(b)
    n, d = X.shape[-2:]
    if aux.dtype != torch.float32 or aux.shape != X.shape[:-1]:
        raise ValueError(f"want {tuple(X.shape[:-1])} float32 aux, got "
                         f"{aux.dtype} {tuple(aux.shape)}")
    if i0.numel() != b or i0.dtype.is_floating_point:
        raise ValueError(f"i0 must be {b} integer(s), got {i0.dtype} "
                         f"{tuple(i0.shape)}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    dev = X.device
    i0 = i0.to(torch.int64).reshape(b).contiguous()
    nblk = -(-n // block)
    # per lane, each lane's bounds are the single call's (same reductions)
    bounds = [persist_tile_bounds(x, metric=metric, block=block)
              for x in X.view(b, n, d)]
    cent = torch.stack([c for c, _ in bounds])
    rad = torch.stack([r for _, r in bounds])
    slack = (lb_slack_ulps(form) * _F32_EPS) * torch.amax(
        aux.view(b, n), dim=1)
    group = persist_plan(b, n, d, metric=metric, form=form, block=block,
                         max_group=max_group)["group"]
    # kernel state, freed on return while the kernel may still run: the
    # caching allocator hands it out again only to later work on this stream
    mind = torch.empty((b, n), dtype=torch.float32, device=dev)
    pend = torch.empty((b, nblk), dtype=torch.float32, device=dev)
    keys = torch.empty((2, b, nblk), dtype=torch.int64, device=dev)
    tiles = torch.empty((3, b, nblk), dtype=torch.int32, device=dev)
    # one slot (a 128-byte line) a CTA and step parity; zeroed: no step's
    # tag
    slots = torch.zeros((b, 2, group, 16), dtype=torch.int64, device=dev)
    order = torch.empty((b, n), dtype=torch.int64, device=dev)
    edges = torch.empty((b, n), dtype=torch.float32, device=dev)
    stats = torch.zeros((b, 4), dtype=torch.int64, device=dev)
    err = _build.library().repro_prim_persist(
        X.data_ptr(), aux.data_ptr(), i0.data_ptr(), cent.data_ptr(),
        rad.data_ptr(), slack.data_ptr(), _LB_MARGIN, b, n, d, block,
        _KINDS[(metric, form)], int(prune), group, mind.data_ptr(),
        pend.data_ptr(), keys[0].data_ptr(), keys[1].data_ptr(),
        tiles[0].data_ptr(), tiles[1].data_ptr(), tiles[2].data_ptr(),
        slots.data_ptr(), order.data_ptr(), edges.data_ptr(),
        stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prim_persist")
    _build.LAUNCHES["prim_persist"] += 1
    if batched:
        return order, edges, stats
    return order[0], edges[0], stats[0]

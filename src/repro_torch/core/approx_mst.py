"""Approximate VAT via a kNN-graph Borůvka MST — the million-point rung.

The port of ``repro/core/approx_mst.py``, name for name.  Exact VAT is a
Prim traversal of the complete graph, O(n²·d) work however it streams.
This rung builds a sparse kNN graph (O(n·k) edges), takes ITS minimum
spanning tree with Borůvka's algorithm, and walks that tree in Prim order
to get a VAT ordering.  The kNN-MST weight is always >= the true MST
weight (it spans with a subset of the edges), with equality exactly when
the true MST lies in the kNN graph; at k = n-1 the two pipelines coincide.

Stages, and where each runs:

  * kNN graph — ``kernels.ops.knn_graph`` (the kNN kernel on the card) up
    to ``EXACT_KNN_N``, else ``knn_graph_anchored``: random anchors
    (≈ sqrt(n)), each point assigned to its ``probes`` nearest anchors
    (``kernels.ops.knn_topk`` in query/candidate form), then brute force
    within every anchor cell at once (``kernels.ops.knn_topk_segmented``):
    on the card two kNN launches in all.  The cell bookkeeping (CSR views
    of the assignment: stable sorts, ``bincount``, ``cumsum``) stays on
    X's device.
  * Borůvka — ``_boruvka_pass`` on X's device: symmetrize the directed
    kNN list (both directions share ONE weight), pick each component's
    minimum incident cross edge by a three-stage lexicographic segment
    minimum on (w, min-endpoint, max-endpoint) — ``scatter_reduce_``
    with "amin", order-independent, so the card and the CPU agree bit
    for bit — hook components along the picks, break the 2-cycles toward
    the smaller root, and collapse labels by pointer jumping.  A host
    loop repeats the pass until no component finds a cross edge
    (<= ceil(log2 n) + 2 passes).
  * connectivity repair — a kNN graph need not be connected.  The
    surviving components are spliced by an exact host Prim over their
    minimum-index representatives' true dissimilarities (the (C, C)
    matrix from ``kernels.ops.pairwise_dist``), or a chain of
    representatives past ``REPAIR_MAX_C``; reported in ``ApproxStats``.
  * ordering — ``mst_vat_order``: a host heap Prim restricted to the
    tree's n-1 edges, whose (weight, vertex) key reproduces exact Prim's
    first-index tie rule; the default seed is the vertex with the largest
    k-NN radius, at k = n-1 exact VAT's "argmax of row max" rule.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import check_metric

#: Largest n the auto mode serves with the exact kNN graph (O(n²·d) work);
#: past it the anchored two-level search keeps the build near-linear.
EXACT_KNN_N = 32_768

#: Largest surviving-component count repaired with an exact Prim over the
#: (C, C) representative matrix; past it a representative chain keeps
#: repair memory O(C).
REPAIR_MAX_C = 4_096


@dataclasses.dataclass(frozen=True)
class ApproxStats:
    """The approx rung's error-model report (rides on ``ResultMeta``).

    Attributes:
      k: neighbours per point actually used (min(k, n-1)).
      mode: "exact" (every pair searched) or "anchored" (two-level).
      n_passes: Borůvka passes until no cross edge remained.
      components: kNN-graph components before repair (1 = no defect).
      repaired_edges: fallback edges spliced in (= components - 1).
      mst_weight: total tree weight, repair included (f64 sum).  Always
        >= the exact MST weight.
      repair_weight: weight contributed by the fallback edges alone —
        with ``repaired_edges`` the spanning-defect estimate (0.0 means
        the kNN graph already spanned).
    """

    k: int
    mode: str
    n_passes: int
    components: int
    repaired_edges: int
    mst_weight: float
    repair_weight: float


class MSTEdges(NamedTuple):
    """A spanning tree as parallel host arrays (n-1 edges when spanning)."""
    src: np.ndarray      # (m,) int32
    dst: np.ndarray      # (m,) int32
    weight: np.ndarray   # (m,) float32


class ApproxVATResult(NamedTuple):
    """Approximate VAT ordering + its MST edge trace + the error report."""
    order: torch.Tensor  # (n,) int64 visit order, on X's device
    edges: torch.Tensor  # (n,) f32 per-visit tree edge (edges[0] = 0)
    stats: ApproxStats


def _boruvka_pass(comp, src, dst, w):
    """One Borůvka round: per-component min cross edge, hook, collapse.

    Args:
      comp: (n,) int64 — current component label per vertex (a vertex id;
        label arrays double as the union-find forest).
      src, dst: (m,) int64 — directed edge endpoints, both directions
        present, self-loops allowed (they mask out as cu == cv).
      w: (m,) float32 — edge weights, identical for the two directions
        of one edge.

    Returns:
      (new_comp (n,) i64, va (n,) i64, vb (n,) i64, ew (n,) f32,
       rec (n,) bool): per component-root c, the selected edge
      (va[c], vb[c], ew[c]) and whether to record it (rec — False for
      rootless indices and the dropped side of each 2-cycle).
    """
    n = comp.shape[0]
    dev = comp.device
    iota = torch.arange(n, device=dev)
    cu = comp[src]
    cv = comp[dst]
    wm = torch.where(cu != cv, w, torch.inf)
    amin = torch.minimum(src, dst)
    amax = torch.maximum(src, dst)

    def segment_min(vals, fill):
        # an empty segment keeps ``fill`` (include_self=False)
        out = torch.full((n,), fill, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(0, cu, vals, "amin", include_self=False)

    # Lexicographic (w, amin, amax) segment-min, one stage per field —
    # ties on w resolve to one concrete edge pair, which is what rules
    # out hooking cycles longer than 2.
    m1 = segment_min(wm, torch.inf)
    e1 = wm == m1[cu]
    m2 = segment_min(torch.where(e1, amin, n), n)
    e2 = e1 & (amin == m2[cu])
    m3 = segment_min(torch.where(e2, amax, n), n)
    has = torch.isfinite(m1)
    va = torch.where(has, m2, 0)
    vb = torch.where(has, m3, 0)
    ca = comp[va]
    cb = comp[vb]
    parent = torch.where(has, torch.where(ca == iota, cb, ca), iota)
    # 2-cycle break: both sides picked the same edge; keep the smaller
    # root, drop the larger side's copy (equal keys => equal weights, so
    # the recorded weight sum is unaffected).
    drop = has & (parent[parent] == iota) & (iota < parent)
    parent = torch.where(drop, iota, parent)
    while bool((parent != parent[parent]).any()):
        parent = parent[parent]
    return (parent[comp], va, vb, torch.where(has, m1, 0.0), has & ~drop)


def _prim_edges_np(R: np.ndarray) -> list[tuple[int, int, float]]:
    """Exact MST edge list of a dense dissimilarity matrix (host Prim).

    O(C²) numpy — the connectivity-repair solver.  First-index
    tie-breaking via np.argmin, matching the exact engine's rule.
    """
    C = R.shape[0]
    in_tree = np.zeros(C, bool)
    in_tree[0] = True
    best = R[0].astype(np.float64).copy()
    best_from = np.zeros(C, np.int64)
    edges = []
    for _ in range(C - 1):
        cand = np.where(in_tree, np.inf, best)
        v = int(np.argmin(cand))
        edges.append((int(best_from[v]), v, float(best[v])))
        in_tree[v] = True
        upd = R[v] < best
        best_from = np.where(upd, v, best_from)
        best = np.where(upd, R[v], best)
    return edges


def _rowwise_dissim_np(A: np.ndarray, B: np.ndarray, metric: str):
    """Per-row dissimilarity of paired points (repair-chain fallback)."""
    A = A.astype(np.float32)
    B = B.astype(np.float32)
    if metric == "sqeuclidean":
        return np.sum((A - B) ** 2, axis=1)
    if metric == "euclidean":
        return np.sqrt(np.sum((A - B) ** 2, axis=1))
    if metric == "manhattan":
        return np.sum(np.abs(A - B), axis=1)
    na = np.sqrt(np.sum(A * A, axis=1))
    nb = np.sqrt(np.sum(B * B, axis=1))
    denom = np.maximum(na * nb, 1e-12)
    return np.clip(1.0 - np.sum(A * B, axis=1) / denom, 0.0, 2.0)


def _as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
    return t.to(device=device if device is not None else t.device,
                dtype=dtype if dtype is not None else t.dtype)


def boruvka_mst(idx, dist, *, X=None, metric: str = "euclidean"):
    """MST of a directed kNN graph + connectivity repair.

    The passes run on the device of ``idx`` (a tensor; numpy arrays are
    taken on the CPU), the repair and the result on the host.

    Args:
      idx: (n, k) int — per-row neighbour indices; self-loops mark
        invalid slots and are ignored.
      dist: (n, k) float — matching dissimilarities.  Each directed
        entry is symmetrized in here (both directions share its weight),
        so duplicate (u, v)/(v, u) discoveries become parallel edges of a
        multigraph rather than an inconsistently-weighted edge.
      X: (n, d) float or None — required only when the graph turns out
        disconnected (repair computes true representative distances).
      metric: one of ``kernels.ref.METRICS`` (repair edges only).

    Returns:
      (MSTEdges, n_passes, components, repair_weight): the spanning edge
      list (always n-1 edges), the Borůvka pass count, the pre-repair
      component count, and the repair's weight contribution.
    """
    check_metric(metric)
    idx = _as_tensor(idx, torch.int64)
    dist = _as_tensor(dist, torch.float32, idx.device)
    dev = idx.device
    n, k = idx.shape
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    flat_i = idx.reshape(-1)
    flat_d = dist.reshape(-1)
    src = torch.cat([rows, flat_i])
    dst = torch.cat([flat_i, rows])
    w = torch.cat([flat_d, flat_d])

    comp = torch.arange(n, device=dev)
    es, ed, ew = [], [], []
    passes = 0
    cap = int(math.ceil(math.log2(max(n, 2)))) + 2
    while passes < cap:
        comp, va, vb, pw, rec = _boruvka_pass(comp, src, dst, w)
        if not bool(rec.any()):
            break
        passes += 1
        es.append(va[rec].cpu().numpy())
        ed.append(vb[rec].cpu().numpy())
        ew.append(pw[rec].cpu().numpy())

    comp_np = comp.cpu().numpy()
    roots = np.unique(comp_np)
    ncomp = int(roots.size)
    repair_w = 0.0
    if ncomp > 1:
        if X is None:
            raise ValueError(
                "kNN graph is disconnected; pass X so the spanning repair "
                "can compute fallback edges")
        Xt = _as_tensor(X, torch.float32)
        reps = np.full(n, n, np.int64)
        np.minimum.at(reps, comp_np, np.arange(n))
        reps = reps[roots]                       # min vertex per component
        Xr = Xt.index_select(0, torch.as_tensor(reps, device=Xt.device))
        if ncomp <= REPAIR_MAX_C:
            R = kops.pairwise_dist(Xr.contiguous(),
                                   metric=metric).cpu().numpy()
            extra = _prim_edges_np(R)
            ra = reps[[a for a, _, _ in extra]]
            rb = reps[[b for _, b, _ in extra]]
            rw = np.asarray([wgt for _, _, wgt in extra], np.float32)
        else:  # too many islands for a (C, C) matrix: chain them
            ra, rb = reps[:-1], reps[1:]
            Xn = Xr.cpu().numpy()
            rw = _rowwise_dissim_np(Xn[:-1], Xn[1:], metric).astype(
                np.float32)
        es.append(ra)
        ed.append(rb)
        ew.append(rw)
        repair_w = float(np.sum(rw, dtype=np.float64))

    if es:
        tree = MSTEdges(np.concatenate(es).astype(np.int32),
                        np.concatenate(ed).astype(np.int32),
                        np.concatenate(ew).astype(np.float32))
    else:  # n == 1
        tree = MSTEdges(np.empty(0, np.int32), np.empty(0, np.int32),
                        np.empty(0, np.float32))
    return tree, passes, ncomp, repair_w


def mst_vat_order(n: int, tree: MSTEdges, i0: int):
    """VAT ordering of a spanning tree: Prim restricted to tree edges.

    On a tree, Prim's traversal from any vertex visits every vertex by
    its unique lightest connection to the visited set — the heap key
    (weight, vertex) reproduces exact Prim's (min value, first index)
    tie rule, so restricted to the TRUE MST this equals full-graph
    Prim's order for the same seed.  A host walk (Python ``heapq``).

    Args:
      n: vertex count.
      tree: spanning edge list (n-1 edges).
      i0: seed vertex.

    Returns:
      (order (n,) int32, edges (n,) float32) host arrays — visit order and
      each visit's tree edge weight (edges[0] = 0).
    """
    starts = np.concatenate([tree.src, tree.dst]).astype(np.int64)
    ends = np.concatenate([tree.dst, tree.src]).astype(np.int64)
    ws = np.concatenate([tree.weight, tree.weight]).astype(np.float64)
    perm = np.argsort(starts, kind="stable")
    ends = ends[perm]
    ws = ws[perm]
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(starts, minlength=n), out=off[1:])

    order = np.empty(n, np.int32)
    edges = np.zeros(n, np.float32)
    visited = np.zeros(n, bool)
    best = np.full(n, np.inf)
    best[i0] = 0.0
    heap = [(0.0, int(i0))]
    t = 0
    while heap and t < n:
        wv, v = heapq.heappop(heap)
        if visited[v] or wv > best[v]:
            continue
        visited[v] = True
        order[t] = v
        edges[t] = wv
        t += 1
        for e in range(off[v], off[v + 1]):
            u = int(ends[e])
            if not visited[u] and ws[e] < best[u]:
                best[u] = ws[e]
                heapq.heappush(heap, (float(ws[e]), u))
    if t < n:  # unreachable once repair guarantees spanning; keep total
        rest = np.flatnonzero(~visited)
        order[t:] = rest
        edges[t:] = 0.0
    return order, edges


class AnchorCells(NamedTuple):
    """The first level of the anchored search, as segments of one
    ``kernels.ops.knn_topk_segmented`` call.  Cell g's queries are the
    points ``query[qoff[g]:qoff[g+1]]`` (every (point, probe) pair probing
    it, in (probe, point) order; pair p = point * probes + probe is
    ``pairs[qoff[g] + i]``) and its candidates its primary members
    ``members[coff[g]:coff[g+1]]``, in index order.  All on X's device."""
    anchors: torch.Tensor   # (c,) int64 — the anchors' point indices
    query: torch.Tensor     # (n * probes,) int64
    pairs: torch.Tensor     # (n * probes,) int64
    qoff: torch.Tensor      # (c + 1,) int64
    members: torch.Tensor   # (n,) int64
    coff: torch.Tensor      # (c + 1,) int64


def anchor_cells(Xt: torch.Tensor, *, metric: str = "euclidean",
                 anchors: int | None = None, probes: int = 2,
                 assign_block: int = 8_192,
                 rng: np.random.Generator | None = None) -> AnchorCells:
    """Sample the anchors, assign every point of Xt (n, d) f32 to its
    ``probes`` nearest, and lay the cells out as segments
    (``knn_graph_anchored`` documents the arguments).  The assignment is
    one ``kernels.ops.knn_topk`` call on the card (its kernel forms no
    (rows, anchors) block), blocks of ``assign_block`` rows on the CPU; the
    CSR views are stable sorts, ``bincount`` and ``cumsum`` on Xt's
    device, the orders numpy's stable argsorts give the reference."""
    dev = Xt.device
    n = Xt.shape[0]
    c = anchors if anchors is not None else max(32, int(round(math.sqrt(n))))
    c = min(c, n)
    probes = max(1, min(probes, c))
    rng = rng if rng is not None else np.random.default_rng(0)
    aidx = torch.as_tensor(rng.choice(n, size=c, replace=False), device=dev)
    A = Xt.index_select(0, aidx)
    anchor_ids = torch.arange(c, device=dev)

    block = n if Xt.is_cuda else assign_block
    probe_idx = torch.empty((n, probes), dtype=torch.int64, device=dev)
    for s0 in range(0, n, block):
        xb = Xt[s0:s0 + block]
        no_id = torch.full((xb.shape[0],), -1, dtype=torch.int64, device=dev)
        _, pid = kops.knn_topk(xb, A, no_id, anchor_ids, k=probes,
                               metric=metric)
        probe_idx[s0:s0 + xb.shape[0]] = pid

    primary = probe_idx[:, 0]
    cells = probe_idx.reshape(-1)
    pairs = torch.argsort(cells * probes + torch.arange(
        probes, device=dev).repeat(n), stable=True)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    return AnchorCells(
        anchors=aidx,
        query=torch.div(pairs, probes, rounding_mode="floor"), pairs=pairs,
        qoff=torch.cat([zero, torch.cumsum(torch.bincount(
            cells, minlength=c), 0)]),
        members=torch.argsort(primary, stable=True),
        coff=torch.cat([zero, torch.cumsum(torch.bincount(
            primary, minlength=c), 0)]))


def knn_graph_anchored(X, *, k: int, metric: str = "euclidean",
                       anchors: int | None = None, probes: int = 2,
                       assign_block: int = 8_192,
                       rng: np.random.Generator | None = None):
    """Approximate kNN graph by two-level (IVF-style) search.

    Sample ``anchors`` random points (≈ sqrt(n) by default), assign every
    point to its ``probes`` nearest anchors, then brute-force each anchor
    cell: the candidates are the cell's primary members, the queries
    everyone probing it (``anchor_cells``).  Probe pools are disjoint
    (primary assignment partitions the data), so the per-point merge over
    probes needs no dedup.  The assignment is one ``kernels.ops.knn_topk``
    call with the anchors' positions as candidate ids and a sentinel query
    id (no self mask); the cells are one ``kernels.ops.knn_topk_segmented``
    call, every cell a segment with the points' own ids: on the card two
    kNN launches, and nothing (n, n) exists.  A list depends only on its
    query and its cell's candidate set, so the graph is the per-cell
    calls' bit for bit.

    Args:
      X: (n, d) float32 tensor (numpy is taken on the CPU).
      k: neighbours per point.
      metric: one of ``kernels.ref.METRICS``.
      anchors: cell count; None = max(32, round(sqrt(n))).
      probes: anchor cells searched per point.
      assign_block: rows per assignment call on the CPU.
      rng: anchor-sampling generator (``np.random.default_rng(0)`` when
        None, as in the reference, so both pick the same anchors).

    Returns:
      (dist (n, k) f32, idx (n, k) int64) on X's device — ascending per
      row; slots the probed cells could not fill hold (inf, -1).
    """
    check_metric(metric)
    Xt = _as_tensor(X, torch.float32).contiguous()
    n = Xt.shape[0]
    cells = anchor_cells(Xt, metric=metric, anchors=anchors, probes=probes,
                         assign_block=assign_block, rng=rng)
    gd, gi = kops.knn_topk_segmented(
        Xt.index_select(0, cells.query), Xt.index_select(0, cells.members),
        cells.query, cells.members, cells.qoff, cells.coff, k=k,
        metric=metric)
    part_d = torch.empty_like(gd)
    part_i = torch.empty_like(gi)
    part_d[cells.pairs] = gd                # row p = point * probes + probe
    part_i[cells.pairs] = torch.where(torch.isfinite(gd), gi, -1)

    flat_d = part_d.reshape(n, -1)
    flat_i = part_i.reshape(n, -1)
    sel = torch.argsort(flat_d, dim=1, stable=True)[:, :k]
    return flat_d.gather(1, sel), flat_i.gather(1, sel)


def approx_vat(X, *, k: int = 15, metric: str = "euclidean",
               knn_mode: str = "auto", probes: int = 2,
               anchors: int | None = None, seed_vertex: int | None = None,
               rng: np.random.Generator | None = None) -> ApproxVATResult:
    """kNN-graph Borůvka VAT — the whole approximate pipeline.

    Args:
      X: (n, d) float tensor — data points (cast to f32; numpy is taken
        on the CPU).  Every stage runs on X's device but the tree walk
        and the repair's host Prim.
      k: neighbours per point — THE error-bound knob.  The kNN-MST weight
        is non-increasing in k and reaches the exact MST weight at
        k = n-1.
      metric: one of ``kernels.ref.METRICS``.
      knn_mode: "auto" (exact kNN up to ``EXACT_KNN_N``, then anchored),
        "exact", or "anchored".
      probes / anchors: anchored-search knobs (``knn_graph_anchored``).
      seed_vertex: traversal seed; None picks the vertex with the largest
        k-NN radius (first index among equals) — at k = n-1 exactly the
        exact engine's argmax-of-row-max seed rule.
      rng: anchor sampling generator (anchored mode only).

    Returns:
      ``ApproxVATResult`` (order and per-visit edge trace on X's device,
      ``ApproxStats``).
    """
    check_metric(metric)
    if knn_mode not in ("auto", "exact", "anchored"):
        raise ValueError(f"knn_mode must be auto|exact|anchored, "
                         f"got {knn_mode!r}")
    Xt = _as_tensor(X, torch.float32).contiguous()
    dev = Xt.device
    n = Xt.shape[0]
    if n == 1:
        stats = ApproxStats(k=0, mode="exact", n_passes=0, components=1,
                            repaired_edges=0, mst_weight=0.0,
                            repair_weight=0.0)
        return ApproxVATResult(torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.zeros(1, device=dev), stats)
    k_eff = min(k, n - 1)
    exact = knn_mode == "exact" or (knn_mode == "auto" and n <= EXACT_KNN_N)
    if exact:
        dist, idx = kops.knn_graph(Xt, k=k_eff, metric=metric)
        mode = "exact"
    else:
        dist, idx = knn_graph_anchored(Xt, k=k_eff, metric=metric,
                                       anchors=anchors, probes=probes,
                                       rng=rng)
        mode = "anchored"

    finite = torch.isfinite(dist) & (idx >= 0)
    radius = torch.where(finite, dist, -torch.inf).amax(dim=1)
    i0 = int(seed_vertex) if seed_vertex is not None \
        else int(torch.argmax(radius))
    rows = torch.arange(n, device=dev)
    idx = torch.where(finite, idx, rows[:, None])
    dist = torch.where(finite, dist, 0.0)

    tree, passes, ncomp, repair_w = boruvka_mst(idx, dist, X=Xt,
                                               metric=metric)
    order, edges = mst_vat_order(n, tree, i0)
    stats = ApproxStats(
        k=k_eff, mode=mode, n_passes=passes, components=ncomp,
        repaired_edges=max(ncomp - 1, 0),
        mst_weight=float(np.sum(tree.weight, dtype=np.float64)),
        repair_weight=repair_w)
    return ApproxVATResult(
        torch.as_tensor(order.astype(np.int64), device=dev),
        torch.as_tensor(edges, device=dev), stats)

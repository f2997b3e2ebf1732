"""The port's approx rung held against the JAX package's, on the CPU.

The same numpy inputs go through ``repro`` (its Pallas kNN kernel in
interpret mode, its blocked XLA path and its Borůvka) and through
``repro_torch``, whose CPU path is the plain PyTorch versions of its
kernels.  The CUDA kNN kernel itself is held in ``test_torch_cuda.py`` on a
GPU.

Tolerances: where no rounding happens — kNN lists on integer-coordinate
data (every dot product, norm and squared distance an exact f32 integer),
Borůvka and the tree walk fed the same arrays, the k = n-1 order — the
two packages must agree bit for bit.  On float data, kNN distances agree
within the pairwise tolerance of ``test_torch_kernels.py``: a sqrt of the
Gram cancellation floor for euclidean, 1e-5 of the scale (+1e-6)
otherwise.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as jcore
from repro.core import approx_mst as japprox
from repro.kernels import knn_graph as jknn
from repro.kernels import ref as jref
from repro_torch import FastVAT, core
from repro_torch.api import registry
from repro_torch.core import approx_mst
from repro_torch.kernels import knn_graph, ops, ref

F32_EPS = float(np.finfo(np.float32).eps)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _int_points(n, d=4, seed=0, span=6):
    """Integer coordinates: every entry of every kNN path is exact in f32,
    ties included, so both frameworks give the same bits."""
    rng = np.random.default_rng(seed)
    return rng.integers(-span, span + 1, size=(n, d)).astype(np.float32)


def _int_blobs(centers, per, seed=0, spread=2):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.asarray(c, np.float32) + rng.integers(
            -spread, spread + 1, size=(per, len(c))).astype(np.float32)
        for c in centers])


def _data(seed, n, d=4):
    """Spread float points, as the reference's suite draws them: distance
    ties occur only where planted."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
            ).astype(np.float32)


def _blobs(n, k=3, d=2, seed=0, sep=40.0):
    rng = np.random.default_rng(seed)
    centers = (sep * rng.normal(size=(k, d))).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    X = centers[lab] + rng.normal(scale=1.0, size=(n, d)).astype(np.float32)
    return X.astype(np.float32), lab.astype(np.int32)


def _runs(lab, order) -> int:
    lo = lab[np.asarray(order)]
    return 1 + int(np.sum(lo[1:] != lo[:-1]))


def _tolerance(metric, X, want):
    if metric == "euclidean":
        sq = float(np.max(np.sum(np.float64(X) ** 2, axis=1)))
        return (16 * F32_EPS * sq) ** 0.5
    return 1e-5 * float(np.max(np.abs(want))) + 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _lower_threshold(monkeypatch, name, threshold):
    monkeypatch.setitem(
        registry._REGISTRY, name,
        dataclasses.replace(registry.get_rung(name),
                            auto_threshold=threshold))


# ------------------------------------------------ the plain versions ----

@pytest.mark.parametrize("metric", ref.METRICS)
def test_knn_graph_ref_bitwise_on_integer_data(metric):
    X = _int_points(70, d=5, seed=1)
    for k in (1, 7):
        got_d, got_i = ref.knn_graph_ref(_t(X), k=k, metric=metric)
        for want_d, want_i in (
                jref.knn_graph_ref(jnp.asarray(X), k=k, metric=metric),
                jknn.knn_graph_pallas(jnp.asarray(X), k=k, metric=metric,
                                      block=32, interpret=True),
                jknn.knn_graph_blocked(jnp.asarray(X), k=k, metric=metric,
                                       block=16)):
            np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the public CPU route is the plain version
    od, oi = ops.knn_graph(_t(X), k=7, metric=metric)
    np.testing.assert_array_equal(od.numpy(), got_d.numpy())
    np.testing.assert_array_equal(oi.numpy(), got_i.numpy())


@pytest.mark.parametrize("metric", ref.METRICS)
def test_knn_graph_ref_float_data_within_tolerance(metric):
    X = _data(2, 90, d=6)
    got_d, _ = ref.knn_graph_ref(_t(X), k=9, metric=metric)
    want_d, _ = jknn.knn_graph_blocked(jnp.asarray(X), k=9, metric=metric,
                                       block=32)
    want_d = np.asarray(want_d)
    assert np.max(np.abs(got_d.numpy() - want_d)) <= _tolerance(
        metric, X, want_d)


@pytest.mark.parametrize("metric", ref.METRICS)
def test_knn_topk_ref_matches_cell_topk(metric):
    """Query/candidate form with the reference's padding sentinels (query
    -2, candidate -1), a query that is also a candidate (self-masked), and
    more slots than valid candidates: (+inf, -1) there."""
    rng = np.random.default_rng(3)
    X = _int_points(40, d=3, seed=3)
    cand = np.sort(rng.choice(40, size=6, replace=False))
    q = np.concatenate([cand[:2], rng.choice(40, size=5, replace=False)])
    Xq = np.zeros((8, 3), np.float32)
    Xq[:q.size] = X[q]
    Xc = np.zeros((8, 3), np.float32)
    Xc[:cand.size] = X[cand]
    qid = np.full(8, -2, np.int32)
    qid[:q.size] = q
    cid = np.full(8, -1, np.int32)
    cid[:cand.size] = cand
    kk = 8
    wd, wi = japprox._cell_topk(jnp.asarray(Xq), jnp.asarray(Xc),
                                jnp.asarray(qid), jnp.asarray(cid),
                                metric=metric, kk=kk)
    wd = np.asarray(wd)
    wi = np.where(np.isfinite(wd), np.asarray(wi), -1)
    gd, gi = ref.knn_topk_ref(_t(Xq), _t(Xc), _t(qid), _t(cid), k=kk,
                              metric=metric)
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert (gi[:2] == -1).sum(dim=1).tolist() == [3, 3]  # 5 valid of 6 cands


@pytest.mark.parametrize("k", [1, 5, 39])
def test_blocked_route_equals_the_plain_lists(k):
    """``knn_topk_blocked`` (the card's route past MAX_K) merges tiles by
    stable sorts; on the same tile values its lists are the plain
    version's, ties and empty slots included."""
    X = _int_points(40, d=3, seed=4, span=2)          # many exact ties
    ids = torch.arange(40)
    want = ref.knn_topk_ref(_t(X), _t(X), ids, ids, k=k)
    got = knn_graph.knn_topk_blocked(_t(X), _t(X), ids, ids, k=k, rows=16,
                                     cols=7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cid = torch.where(ids % 3 == 0, -1, ids)        # padded candidates
    want = ref.knn_topk_ref(_t(X), _t(X), ids, cid, k=k)
    got = knn_graph.knn_topk_blocked(_t(X), _t(X), ids, cid, k=k, rows=16,
                                     cols=7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------- Borůvka ----

def _same_tree(got, want):
    (gt, gp, gc, gr), (wt, wp, wc, wr) = got, want
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (gp, gc, gr) == (wp, wc, wr)


def _ref_graph(X, k):
    d, i = jknn.knn_graph_blocked(jnp.asarray(X), k=k, block=64)
    return np.asarray(i), np.asarray(d)


def test_boruvka_disconnected_blobs_match_reference():
    """Four blobs 1,000 apart at k = 3: no kNN edge crosses blobs, the
    repair splices them with the exact representative Prim."""
    X = _int_blobs([[0, 0], [1000, 0], [0, 1000], [1000, 1000]], 100)
    idx, dist = _ref_graph(X, 3)
    got = core.boruvka_mst(idx, dist, X=X)
    want = japprox.boruvka_mst(idx, dist, X=X)
    _same_tree(got, want)
    assert got[2] >= 4 and got[3] >= 3 * 900


def test_boruvka_chain_repair_matches_reference(monkeypatch):
    monkeypatch.setattr(approx_mst, "REPAIR_MAX_C", 2)
    monkeypatch.setattr(japprox, "REPAIR_MAX_C", 2)
    X = _int_blobs([[0, 0], [500, 0], [0, 500]], 60, seed=1)
    idx, dist = _ref_graph(X, 3)
    got = core.boruvka_mst(idx, dist, X=X)
    _same_tree(got, japprox.boruvka_mst(idx, dist, X=X))
    assert got[2] >= 3 and got[3] > 0.0


def test_boruvka_duplicate_points_match_reference():
    """Every point three times: zero-distance ties everywhere."""
    X = np.repeat(_int_points(15, d=2, seed=5), 3, axis=0)
    idx, dist = _ref_graph(X, 6)
    got = core.boruvka_mst(idx, dist, X=X)
    _same_tree(got, japprox.boruvka_mst(idx, dist, X=X))
    assert got[0].src.size == X.shape[0] - 1
    assert got[1] <= int(np.ceil(np.log2(X.shape[0]))) + 2


def test_boruvka_disconnected_without_x_raises():
    idx = np.array([[1], [0], [3], [2]], np.int32)
    with pytest.raises(ValueError, match="disconnected"):
        core.boruvka_mst(idx, np.ones((4, 1), np.float32))


def test_mst_vat_order_matches_reference():
    X = _int_blobs([[0, 0, 0], [40, 0, 0], [0, 40, 0]], 50, seed=6)
    idx, dist = _ref_graph(X, 5)
    tree, _, _, _ = japprox.boruvka_mst(idx, dist, X=X)
    for i0 in (0, 77, 149):
        go, ge = core.mst_vat_order(X.shape[0], tree, i0)
        wo, we = japprox.mst_vat_order(X.shape[0], tree, i0)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(ge, we)


# -------------------------------------------------- the kNN graphs ----

def test_anchored_graph_matches_reference_on_integer_data():
    """The same anchors (numpy ``default_rng(0)``), the same assignment and
    cell lists: the two anchored graphs agree bit for bit."""
    X = _int_blobs([[0, 0, 0], [30, 0, 0], [0, 30, 0], [0, 0, 30]], 400,
                   seed=7, spread=4)
    gd, gi = core.knn_graph_anchored(X, k=6)
    wd, wi = japprox.knn_graph_anchored(X, k=6)
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_anchored_knn_never_materializes_nxn(monkeypatch):
    """Every query/candidate block of the anchored search is at most
    (assign_block, anchors) or one cell: nothing (n, n).  The cells are one
    segmented call; its segments are recorded one by one."""
    n, ab = 5_000, 1_024
    X, _ = _blobs(n, k=3, seed=5)
    shapes, segments = [], []
    real, real_segmented = ops.knn_topk, ops.knn_topk_segmented

    def recording(Xq, Xc, qid, cid, **kw):
        shapes.append((Xq.shape[0], Xc.shape[0]))
        return real(Xq, Xc, qid, cid, **kw)

    def recording_segmented(Xq, Xc, qid, cid, qoff, coff, **kw):
        segments.extend(zip(torch.diff(qoff).tolist(),
                            torch.diff(coff).tolist()))
        return real_segmented(Xq, Xc, qid, cid, qoff, coff, **kw)

    monkeypatch.setattr(ops, "knn_topk", recording)
    monkeypatch.setattr(ops, "knn_topk_segmented", recording_segmented)
    dist, idx = core.knn_graph_anchored(X, k=6, assign_block=ab)
    assert dist.shape == (n, 6) and dist.dtype == torch.float32
    assert shapes and all(r <= ab and c < n for r, c in shapes), shapes
    assert len(segments) == 71                    # round(sqrt(5,000)) cells
    assert sum(q for q, _ in segments) == 2 * n   # two probes a point
    assert all(q < n and c < n for q, c in segments), segments
    assert (torch.isfinite(dist) & (idx >= 0)).float().mean() > 0.95


# ---------------------------------------------------- the pipeline ----

@pytest.mark.parametrize("metric", ref.METRICS)
@pytest.mark.parametrize("n", [37, 400])
def test_full_k_order_equals_the_exact_orders(metric, n):
    """At k = n-1 the approx order is exact Prim's: the port's flashvat
    and vat orders, bit for bit."""
    X = _data(11 + n, n, 3)
    res = core.approx_vat(X, k=n - 1, knn_mode="exact", metric=metric)
    flash = core.vat_matrix_free(_t(X), metric=metric)
    vat = core.vat(_t(X), metric=metric)
    assert torch.equal(res.order, flash.order)
    assert torch.equal(res.order, vat.order)
    assert res.stats.components == 1 and res.stats.k == n - 1


def test_full_k_order_matches_reference_on_integer_data():
    X = _int_points(120, d=3, seed=8, span=40)
    got = core.approx_vat(X, k=119, knn_mode="exact")
    want = japprox.approx_vat(X, k=119, knn_mode="exact")
    np.testing.assert_array_equal(got.order.numpy(), want.order)
    np.testing.assert_array_equal(got.edges.numpy(), want.edges)
    assert dataclasses.astuple(got.stats) == dataclasses.astuple(want.stats)


def test_small_n_and_validation():
    assert core.approx_vat(_data(0, 1, 3)).order.tolist() == [0]
    res2 = core.approx_vat(_data(0, 2, 3), k=50)
    assert sorted(res2.order.tolist()) == [0, 1] and res2.stats.k == 1
    with pytest.raises(ValueError, match="knn_mode"):
        core.approx_vat(_data(0, 8, 2), knn_mode="bogus")


# --------------------------------------------------------- the API ----

def test_auto_fit_routes_approx_past_threshold(monkeypatch):
    _lower_threshold(monkeypatch, "vat", 50)
    _lower_threshold(monkeypatch, "flashvat", 100)
    assert registry.select_method(100) == "flashvat"
    assert registry.select_method(101) == "approx"
    X, lab = _blobs(300, k=3, seed=2)
    fv = FastVAT(sample_size=32, knn_k=8, device="cpu").fit(X)
    assert fv.method_resolved == "approx"
    assert sorted(fv.order().tolist()) == list(range(300))
    assert fv.image(resolution=64).shape == (64, 64)
    s = fv.result.meta.approx
    assert isinstance(s, core.ApproxStats) and s.k == 8   # knn_k honoured
    rep = fv.assess()
    assert rep["method"] == "approx" and rep["k_est"] == 3
    assert FastVAT.from_result(fv.result, fv._X.numpy()).knn_k == 8


def test_auto_above_medium_n_is_approx():
    X, _ = _blobs(registry.MEDIUM_N + 1, k=3, seed=9)
    fv = FastVAT(device="cpu").fit(X)
    s = fv.result.meta.approx
    assert fv.method_resolved == "approx" and s.mode == "anchored"
    assert s.k == 15 and s.repaired_edges == s.components - 1
    assert fv.result.rstar.shape == (256, 256)


def test_approx_rejects_precomputed():
    X, _ = _blobs(60, seed=3)
    D = ops.pairwise_dist(_t(X)).numpy()
    with pytest.raises(ValueError, match="precomputed"):
        FastVAT(method="approx", metric="precomputed", device="cpu").fit(D)
    assert registry.select_method(10 ** 6, precomputed=True) == "vat"
    fv = FastVAT(metric="precomputed", device="cpu").fit(D)
    assert fv.method_resolved == "vat" and fv.result.meta.approx is None


def test_approx_fit_matches_reference_fit():
    """The whole rung on tie-free float data: the same order as repro's,
    the same stats, and the band matrix within the pairwise tolerance."""
    X, _ = _blobs(600, k=4, d=3, seed=10)
    got = FastVAT(method="approx", sample_size=32, knn_k=10,
                  device="cpu").fit(X)
    from repro import FastVAT as JFastVAT
    want = JFastVAT(method="approx", sample_size=32, knn_k=10).fit(X)
    np.testing.assert_array_equal(got.order(), want.order())
    assert got.result.meta.approx.components == \
        want.result.meta.approx.components
    wr = np.asarray(want.result.rstar)
    # each of the n - 1 tree edges within the pairwise tolerance
    assert abs(got.result.meta.approx.mst_weight
               - want.result.meta.approx.mst_weight) <= \
        (X.shape[0] - 1) * _tolerance("euclidean", X, wr)
    assert np.max(np.abs(got.result.rstar.numpy() - wr)) <= _tolerance(
        "euclidean", X, wr)
    assert got.assess().k_est == want.assess().k_est


def test_approx_demo_shaped_run(monkeypatch):
    """The reference demo's data at test size through the port: 5 blobs
    give 5 runs, and no pairwise block is anywhere near (n, n)."""
    spec = importlib.util.spec_from_file_location(
        "approx_demo", ROOT / "examples" / "approx_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    n = 1_500
    X, lab = demo.make_blobs(n)
    shapes = []
    real = ops.pairwise_dist

    def recording(Xa, Ya=None, **kw):
        out = real(Xa, Ya, **kw)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(ops, "pairwise_dist", recording)
    fv = FastVAT(method="approx", knn_k=6, sample_size=32,
                 device="cpu").fit(X)
    assert fv.method_resolved == "approx"
    assert sorted(fv.order().tolist()) == list(range(n))
    assert _runs(lab, fv.order()) == 5
    assert fv.result.meta.approx.k == 6
    assert shapes and all(r * c <= n * 64 for r, c in shapes), shapes
    from repro import FastVAT as JFastVAT
    want = JFastVAT(method="approx", knn_k=6, sample_size=32).fit(X)
    assert fv.assess().k_est == want.assess().k_est

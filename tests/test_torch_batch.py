"""The port's batched fits (``fit_many``) held against the JAX package's.

The same numpy stacks go through ``repro`` (its Pallas kernels in interpret
mode where a kernel is under test, its XLA paths behind ``FastVAT``) and
through ``repro_torch``, whose CPU path is the plain PyTorch versions of its
kernels (``kernels/ref.py``).  The CUDA kernels themselves are held in
``test_torch_cuda.py`` on a GPU.

Tolerances: orders are compared exactly on integer-coordinate data, where
every entry is exact in f32 in both frameworks; on float data they are held
by spanning-tree weight within the reference's ``EXCESS_F32 = 1e-5``.
Distance values (matrices, rows, edges, images) are held within the
pairwise tolerances of ``test_torch_kernels.py`` — a sqrt of the Gram
cancellation floor for gram-form euclidean, 1e-5 of the scale (+1e-6)
otherwise — since the two frameworks round the cross term in different
places.  Inside the port, each lane of a batched call equals the single
call on that lane bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
from repro import core as jcore
from repro.api import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels import prim_stream as jps
from repro.kernels import ref as jref
from repro_torch import FastVAT, core
from repro_torch.api import registry
from repro_torch.api.result import ResultMeta, TendencyResult
from repro_torch.core.vat import _streamed_seed_pivot
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.knn_graph import knn_graph_batch_cuda
from repro_torch.kernels.pairwise_dist import pairwise_dist_batch_cuda
from repro_torch.kernels.prim_stream import prim_stream_step_batch_cuda

F32_EPS = float(np.finfo(np.float32).eps)
FORMS = ("gram", "direct")
EXCESS_F32 = 1e-5


def _tolerance(metric, form, X, want):
    """The pairwise tolerance over a whole stack X (..., n, d)."""
    if metric == "euclidean" and form == "gram":
        sq = float(np.max(np.sum(np.float64(X) ** 2, axis=-1)))
        return (16 * F32_EPS * sq) ** 0.5
    finite = np.asarray(want)[np.isfinite(want)]
    return 1e-5 * float(np.max(np.abs(finite))) + 1e-6


def _stack(b, n, d, seed=0):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, size=d)
    return (rng.normal(size=(b, n, d)) * scale).astype(np.float32)


def _int_blobs(b, n, d=6, k=3, seed=0):
    """b stacks of clusters on integer coordinates: every dot product, norm
    and squared distance is an exact f32 integer, so both frameworks
    compute every entry to the same bits, exact ties included."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        centers = rng.integers(-12, 13, size=(k, d))
        out.append(centers[np.arange(n) % k]
                   + rng.integers(-3, 4, size=(n, d)))
    return np.asarray(out, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tree_weight(X, order):
    """Spanning-tree weight of a Prim ordering, f64 euclidean."""
    Y = np.float64(X[order])
    sq = np.sum(Y * Y, axis=1)
    d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * Y @ Y.T, 0))
    lower = np.tri(len(Y), k=-1, dtype=bool)
    return float(np.sum(np.min(np.where(lower, d, np.inf)[1:], axis=1)))


# ----------------------------------------------- row 2: pairwise_dist_batch --

@pytest.mark.parametrize("b,n,d", [(3, 67, 3), (8, 33, 20), (1, 130, 20),
                                   (3, 129, 33)])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_pairwise_batch_matches_reference(metric, form, b, n, d):
    """Against the reference's batched Pallas grid (interpret mode), with
    ragged n; exact zero diagonals; each lane the port's single call."""
    X = _stack(b, n, d, seed=b * 100 + n + d)
    got = ops.pairwise_dist_batch(_t(X), metric=metric, form=form)
    assert got.shape == (b, n, n) and got.dtype == torch.float32
    want = np.asarray(jops.pairwise_dist_batch(jnp.asarray(X), metric=metric,
                                               form=form, use_pallas=True))
    assert np.max(np.abs(got.numpy() - want)) <= _tolerance(metric, form, X,
                                                            want)
    assert not torch.diagonal(got, dim1=1, dim2=2).any()
    for z in range(b):
        assert torch.equal(got[z], ops.pairwise_dist(_t(X[z]), metric=metric,
                                                     form=form))


def test_pairwise_batch_bf16_storage():
    """bf16 storage: the batch on bfloat16 values equals it on their f32
    copy, as the single call does."""
    from repro_torch.numerics.condition import _quantize_bf16
    X = _quantize_bf16(_stack(3, 40, 9, seed=5))
    got = ops.pairwise_dist_batch(_t(X).bfloat16())
    assert torch.equal(got, ops.pairwise_dist_batch(_t(X)))


# --------------------------------------------------- row 7: knn_graph_batch --

@pytest.mark.parametrize("k", [1, 5, 49])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_knn_batch_matches_reference(metric, k):
    """Against the reference's batched kNN (its Pallas grid in interpret
    mode up to ``MAX_PALLAS_K``): indices equal, distances within the
    pairwise tolerance; each lane the port's single graph, bit for bit."""
    X = _stack(3, 50, 4, seed=k)
    dist, idx = ops.knn_graph_batch(_t(X), k=k, metric=metric)
    assert dist.shape == idx.shape == (3, 50, k) and idx.dtype == torch.int64
    wd, wi = jops.knn_graph_batch(jnp.asarray(X), k=k, metric=metric,
                                  use_pallas=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    wd = np.asarray(wd)
    assert np.max(np.abs(dist.numpy() - wd)) <= _tolerance(metric, "gram", X,
                                                          wd)
    for z in range(3):
        sd, si = ops.knn_graph(_t(X[z]), k=k, metric=metric)
        assert torch.equal(dist[z], sd) and torch.equal(idx[z], si)


def test_knn_batch_rejects_k_outside_range():
    with pytest.raises(ValueError, match="k must satisfy"):
        ops.knn_graph_batch(torch.zeros(2, 5, 3), k=5)


# --------------------------------------------- row 10: the batched Prim step --

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_prim_stream_step_batch_matches_pallas(metric, form):
    """Five batched steps against ``prim_stream_step_pallas_batch``
    (interpret mode, padded as the reference pads) on integer-coordinate
    data: next vertices bit for bit, frontier and edges too except under
    euclidean, whose values are held within the pairwise tolerance (the
    square root of an exact integer: torch's vectorized CPU sqrt is not
    correctly rounded and can sit one ulp off numpy's, where XLA's agrees
    with numpy's); each lane the port's single step."""
    b, n = 3, 70
    X = _int_blobs(b, n, d=5, seed=1)
    aux = ref.metric_aux_ref(_t(X), metric=metric)
    Xj = jnp.asarray(X)
    jaux = jref.metric_aux_ref(Xj, metric=metric)
    Xp, auxp, n_pad, bn = jps.pad_points(Xj, jaux, block=64)
    q = torch.tensor([0, 17, 69])
    mind = torch.full((b, n), torch.inf)
    sel = torch.zeros((b, n), dtype=torch.bool)
    sel.scatter_(1, q.view(b, 1), True)
    jmind = jnp.full((b, n_pad), jnp.inf, jnp.float32)
    jsel = jnp.asarray(np.concatenate(
        [sel.numpy(), np.ones((b, n_pad - n), bool)], axis=1))
    jq = jnp.asarray(q.numpy(), jnp.int32)
    for _ in range(5):
        lanes = [ref.prim_stream_step_ref(_t(X[z]), aux[z], q[z], mind[z],
                                          sel[z], metric=metric, form=form)
                 for z in range(b)]
        mind, ev, nq = ops.prim_stream_step(_t(X), aux, q, mind, sel,
                                            metric=metric, form=form)
        for z, (m1, e1, q1) in enumerate(lanes):
            assert torch.equal(mind[z], m1) and torch.equal(ev[z], e1) \
                and torch.equal(nq[z], q1)
        jmind, jev, jnq = jps.prim_stream_step_pallas_batch(
            Xp, auxp, jq, jmind, jsel, metric=metric, form=form, block=bn,
            interpret=True)
        np.testing.assert_array_equal(nq.numpy(), np.asarray(jnq))
        jm = np.asarray(jmind)[:, :n]
        if metric == "euclidean":
            tol = _tolerance(metric, "gram", X, jm)
            assert np.max(np.abs(mind.numpy() - jm)) <= tol
            assert np.max(np.abs(ev.numpy() - np.asarray(jev))) <= tol
        else:
            np.testing.assert_array_equal(mind.numpy(), jm)
            np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
        q = nq.clone()
        sel.scatter_(1, q.view(b, 1), True)
        jq = jnp.asarray(q.numpy(), jnp.int32)
        jsel = jsel.at[jnp.arange(b), jq].set(True)


# ------------------------------------------------ masked_argmin lane axis --

def test_masked_argmin_lane_axis_equals_rows():
    rng = np.random.default_rng(3)
    vals = _t(rng.integers(-4, 5, size=(8, 300)).astype(np.float32))
    mask = _t(rng.random((8, 300)) < 0.5)
    mask[5] = True                                  # a fully masked row
    v, i = ops.masked_argmin(vals, mask)
    assert v.shape == i.shape == (8,) and i.dtype == torch.int64
    for z in range(8):
        vz, iz = ops.masked_argmin(vals[z], mask[z])
        assert torch.equal(v[z], vz) and torch.equal(i[z], iz)
    assert float(v[5]) == np.inf and int(i[5]) == 0


# ------------------------------------------- the batched core functions ----

@pytest.mark.parametrize("metric", ref.METRICS)
def test_vat_batch_matches_reference(metric):
    """``core.vat_batch`` against ``repro.core.vat_batch`` with its Pallas
    grid and vmapped argmin kernel (interpret mode): orders bit for bit on
    integer blobs, matrices within tolerance."""
    X = _int_blobs(3, 96, seed=2)
    got = core.vat_batch(_t(X), metric=metric)
    want = jcore.vat_batch(jnp.asarray(X), metric=metric, use_pallas=True)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    wr = np.asarray(want.rstar)
    assert np.max(np.abs(got.rstar.numpy() - wr)) <= _tolerance(
        metric, "gram", X, wr)


def test_batch_from_dist_matches_reference():
    """The precomputed entry points on one shared stack of matrices: the
    Prim orders and iVAT images bit for bit (only min, max and argmin)."""
    X = _stack(3, 80, 4, seed=4)
    R = np.asarray(jops.pairwise_dist_batch(jnp.asarray(X)))
    got = core.vat_batch_from_dist(_t(R))
    want = jcore.vat_batch_from_dist(jnp.asarray(R))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.rstar.numpy(), np.asarray(want.rstar))
    iv, res = core.ivat_batch_from_dist(_t(R))
    jiv, jres = jcore.ivat_batch_from_dist(jnp.asarray(R), use_pallas=True)
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(jres.order))
    np.testing.assert_array_equal(iv.numpy(), np.asarray(jiv))
    np.testing.assert_array_equal(
        core.ivat_batch_from_vat(got.rstar).numpy(),
        np.asarray(jcore.ivat_batch_from_vat(want.rstar)))


def test_ivat_batch_matches_reference():
    X = _int_blobs(3, 90, seed=5)
    iv, res = core.ivat_batch(_t(X))
    jiv, jres = jcore.ivat_batch(jnp.asarray(X), use_pallas=True)
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(jres.order))
    jiv = np.asarray(jiv)
    assert np.max(np.abs(iv.numpy() - jiv)) <= _tolerance("euclidean",
                                                          "gram", X, jiv)


@pytest.mark.parametrize("turbo", [True, False])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_vat_matrix_free_batch_matches_reference(metric, turbo):
    """Both engines against ``repro.core.vat_matrix_free_batch`` (the
    stepwise engine through its batched Pallas step in interpret mode):
    orders bit for bit on integer blobs, edges within tolerance."""
    X = _int_blobs(3, 150, seed=6)
    got = core.vat_matrix_free_batch(_t(X), metric=metric, turbo=turbo)
    want = jcore.vat_matrix_free_batch(jnp.asarray(X), metric=metric,
                                       use_pallas=True, turbo=turbo,
                                       block=64)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    we = np.asarray(want.edges)
    assert np.max(np.abs(got.edges.numpy() - we)) <= _tolerance(
        metric, "gram", X, we)


def test_batch_float_data_within_tree_weight():
    """On float data near-ties at the last bit may flip an order between
    the frameworks (ROADMAP queue 3), so each lane's order is held by
    spanning-tree weight within EXCESS_F32, for both batched engines and
    the materialized batch."""
    X = _stack(3, 200, 5, seed=7)
    Xj = jnp.asarray(X)
    pairs = [(core.vat_batch(_t(X)).order, jcore.vat_batch(Xj).order)]
    for turbo in (True, False):
        pairs.append((core.vat_matrix_free_batch(_t(X), turbo=turbo).order,
                      jcore.vat_matrix_free_batch(Xj, turbo=turbo).order))
    for got, want in pairs:
        for z in range(3):
            wg = _tree_weight(X[z], got[z].numpy())
            ww = _tree_weight(X[z], np.asarray(want[z]))
            assert abs(wg - ww) / ww <= EXCESS_F32


# ------------------------------------------------- lanes == solo, bitwise --

@pytest.mark.parametrize("b", [1, 3, 8])
def test_batched_core_lanes_equal_solo(b):
    """The reference's invariant (tests/test_batch.py, test_turbo.py): each
    lane of every batched core function is the port's single function on
    that lane, bit for bit."""
    X = _stack(b, 64, 3, seed=b)
    Xt = _t(X)
    vb = core.vat_batch(Xt)
    ivb, ires = core.ivat_batch(Xt)
    mfb = core.vat_matrix_free_batch(Xt)
    msb = core.vat_matrix_free_batch(Xt, turbo=False)
    for z in range(b):
        solo = core.vat(Xt[z])
        assert torch.equal(vb.order[z], solo.order)
        assert torch.equal(vb.rstar[z], solo.rstar)
        img, ires_z = core.ivat(ops.pairwise_dist(Xt[z]))
        assert torch.equal(ires.order[z], ires_z.order)
        assert torch.equal(ivb[z], img)
        mf = core.vat_matrix_free(Xt[z])
        ms = core.vat_matrix_free(Xt[z], turbo=False)
        assert torch.equal(mfb.order[z], mf.order)
        assert torch.equal(mfb.edges[z], mf.edges)
        assert torch.equal(msb.order[z], ms.order)
        assert torch.equal(msb.edges[z], ms.edges)


@pytest.mark.parametrize("metric", ref.METRICS)
def test_prim_persist_lanes_equal_solo(metric):
    X = _t(_stack(3, 77, 4, seed=9))
    aux = ops.metric_aux(X, metric=metric)
    i0 = torch.stack([_streamed_seed_pivot(x, metric=metric) for x in X])
    order, edges = ops.prim_persist(X, aux, i0, metric=metric)
    assert order.shape == edges.shape == (3, 77)
    for z in range(3):
        assert torch.equal(aux[z], ops.metric_aux(X[z], metric=metric))
        so, se = ops.prim_persist(X[z], aux[z], i0[z], metric=metric)
        assert torch.equal(order[z], so) and torch.equal(edges[z], se)


# ------------------------------------------- no (b, n, n) in flashvat ----

def test_batched_flashvat_never_materializes(monkeypatch):
    """The batched flashvat forms no matrix of n rows: every operand of
    either pairwise entry stays below n, as the reference's tripwire
    (tests/test_flashvat.py) demands.  The (b, m, m) render and the seed
    scan's blocks pass."""
    n = 700
    real, real_batch = ops.pairwise_dist, ops.pairwise_dist_batch

    def guarded(X, Y=None, **kw):
        if X.shape[0] >= n or (Y is not None and Y.shape[0] >= n):
            raise AssertionError("batched flashvat formed an n-row operand")
        return real(X, Y, **kw)

    def guarded_batch(X, **kw):
        if X.shape[1] >= n:
            raise AssertionError("batched flashvat formed (b, n, n)")
        return real_batch(X, **kw)

    monkeypatch.setattr(ops, "pairwise_dist", guarded)
    monkeypatch.setattr(ops, "pairwise_dist_batch", guarded_batch)
    Xs = _stack(2, n, 3, seed=10)
    for turbo in (None, False):
        fv = FastVAT(method="flashvat", sample_size=64, turbo=turbo,
                     device="cpu").fit_many(Xs)
        assert fv.result.rstar.shape == (2, 64, 64)
        for z in range(2):
            assert sorted(fv.order()[z].tolist()) == list(range(n))


# ------------------------------------------------------ FastVAT.fit_many ----

@pytest.mark.parametrize("method,turbo", [("vat", None), ("ivat", None),
                                          ("flashvat", None),
                                          ("flashvat", False)])
def test_fit_many_matches_reference(method, turbo):
    """fit_many against the reference's on integer blobs: orders bit for
    bit, images within the pairwise tolerance; each lane the port's solo
    fit, bit for bit."""
    Xs = _int_blobs(3, 120, seed=11)
    got = FastVAT(method=method, turbo=turbo, sample_size=64,
                  device="cpu").fit_many(Xs)
    want = repro.FastVAT(method=method, turbo=turbo,
                         sample_size=64).fit_many(Xs)
    assert got.batched and got.result.meta.batch == 3
    np.testing.assert_array_equal(got.order(), np.asarray(want.order()))
    img, wimg = got.image(resolution=64), np.asarray(
        want.image(resolution=64))
    assert img.shape == wimg.shape
    assert np.max(np.abs(img - wimg)) <= 1e-5 * wimg.max() + 1e-6
    for z in range(3):
        solo = FastVAT(method=method, turbo=turbo, sample_size=64,
                       device="cpu").fit(Xs[z])
        np.testing.assert_array_equal(got.order()[z], solo.order())
        np.testing.assert_array_equal(img[z], solo.image(resolution=64))


def test_fit_many_precomputed_matches_reference():
    Xs = _int_blobs(3, 60, seed=12)
    Ds = np.asarray(jops.pairwise_dist_batch(jnp.asarray(Xs)))
    for method in ("vat", "ivat"):
        got = FastVAT(method=method, metric="precomputed",
                      device="cpu").fit_many(Ds)
        want = repro.FastVAT(method=method,
                             metric="precomputed").fit_many(Ds)
        np.testing.assert_array_equal(got.order(), np.asarray(want.order()))
        np.testing.assert_array_equal(got.image(), np.asarray(want.image()))
        reps = got.assess()
        assert [r["batch_index"] for r in reps] == [0, 1, 2]
        assert all(np.isnan(r["hopkins"]) for r in reps)


def test_precomputed_batched_round_trip():
    """The port's counterpart of the reference's
    ``test_metrics.py::test_precomputed_batched_round_trip``: the port's
    own round trip bit for bit (both sides run ``pairwise_dist_batch``
    eagerly), and against the reference orders equal and images within
    the pairwise tolerance (the reference's jitted and eager matrices
    differ by up to 4.8e-7, ROADMAP queue 3)."""
    Xs = np.random.default_rng(19).normal(size=(3, 30, 4)).astype(np.float32)
    direct = FastVAT(method="ivat", device="cpu").fit_many(Xs)
    Ds = ops.pairwise_dist_batch(_t(Xs)).numpy()
    via = FastVAT(method="ivat", metric="precomputed",
                  device="cpu").fit_many(Ds)
    np.testing.assert_array_equal(via.order(), direct.order())
    np.testing.assert_array_equal(via.image(), direct.image())
    reps = via.assess()
    assert len(reps) == 3 and all(np.isnan(r["hopkins"]) for r in reps)
    want = repro.FastVAT(method="ivat").fit_many(Xs)
    np.testing.assert_array_equal(direct.order(), np.asarray(want.order()))
    wimg = np.asarray(want.image())
    assert np.max(np.abs(direct.image() - wimg)) <= _tolerance(
        "euclidean", "gram", Xs, wimg)


def test_fit_many_auto_and_guards_match_reference():
    Xs = _stack(2, 32, 2, seed=5)
    fv = FastVAT(device="cpu").fit_many(Xs)
    assert fv.method_resolved == "vat" and fv.batched
    assert repro.FastVAT().fit_many(Xs).method_resolved == "vat"
    big = _stack(1, registry.SMALL_N + 1, 2, seed=1)
    assert FastVAT(device="cpu", sample_size=16).fit_many(
        big).method_resolved == "flashvat"
    for n in (100, registry.SMALL_N + 1, registry.MEDIUM_N):
        assert registry.select_method(n, batched=True) == \
            jregistry.select_method(n, batched=True)
    for fv_cls, kw in ((FastVAT, {"device": "cpu"}), (repro.FastVAT, {})):
        with pytest.raises(ValueError, match="stack"):
            fv_cls(**kw).fit_many(Xs[0])
    with pytest.raises(ValueError) as port_err:
        FastVAT(method="approx", device="cpu").fit_many(Xs)
    with pytest.raises(ValueError) as ref_err:
        repro.FastVAT(method="approx").fit_many(Xs)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="does not accept"):
        FastVAT(method="flashvat", metric="precomputed",
                device="cpu").fit_many(np.zeros((2, 8, 8), np.float32))


def test_fit_many_refuses_n_past_the_batched_window():
    """Auto refuses n past flashvat's 50,000 before any fit, as the
    reference does."""
    Xs = np.zeros((1, registry.MEDIUM_N + 1, 1), np.float32)
    Xs[0, :, 0] = np.arange(registry.MEDIUM_N + 1)
    with pytest.raises(ValueError, match="n <= 50000"):
        FastVAT(device="cpu").fit_many(Xs)
    with pytest.raises(ValueError, match="n <= 50000"):
        repro.FastVAT().fit_many(Xs)
    assert registry.select_method(registry.MEDIUM_N + 1,
                                  precomputed=True, batched=True) == "vat"


def test_fit_many_assess_reports():
    """b reports with batch_index 0..b-1, Hopkins in (0, 1); the block
    score and k_est equal the solo fit's; lane i's probes come from
    (seed, SALT_ASSESS, i), so the report is repeatable."""
    Xs = _int_blobs(4, 90, seed=13)
    fv = FastVAT(method="ivat", device="cpu").fit_many(Xs)
    reps = fv.assess()
    assert [r["batch_index"] for r in reps] == [0, 1, 2, 3]
    assert reps == fv.assess()
    wreps = repro.FastVAT(method="ivat").fit_many(Xs).assess()
    for z, (rep, wrep) in enumerate(zip(reps, wreps)):
        assert 0.0 < rep["hopkins"] < 1.0
        solo = FastVAT(method="ivat", device="cpu").fit(Xs[z]).assess()
        assert (rep.block_score, rep.k_est) == (solo.block_score, solo.k_est)
        assert rep.k_est == wrep.k_est
        assert abs(rep.block_score - wrep.block_score) <= 1e-5


def test_from_arrays_of_a_batched_reference_fit():
    """Weights carried across: a reference fit_many, moved over as numpy
    arrays, renders and assesses in the port."""
    Xs = _int_blobs(3, 300, seed=14)
    want = repro.FastVAT(method="flashvat", sample_size=32).fit_many(Xs)
    res = want.result
    meta = ResultMeta(method="flashvat", n=300, batch=3, device="cpu",
                      sample_size=32)
    moved = TendencyResult.from_arrays(
        np.asarray(res.order), np.asarray(res.rstar),
        np.asarray(res.ivat_image), meta,
        sample_idx=np.asarray(res.sample_idx),
        extension_labels=np.asarray(res.extension_labels),
        group_sizes=np.asarray(res.group_sizes))
    assert moved.is_batched
    np.testing.assert_array_equal(moved.image(resolution=64),
                                  np.asarray(want.image(resolution=64)))
    fv = FastVAT.from_result(moved, Xs)
    assert fv.batched
    reps = fv.assess()
    wreps = want.assess()
    assert [r.k_est for r in reps] == [r["k_est"] for r in wreps]
    assert all(0.0 < r.hopkins < 1.0 for r in reps)


# --------------------------------------------------------- dispatch ----

def test_cpu_batched_dispatch_launches_no_kernel():
    _build.reset_launch_counts()
    X = _t(_stack(2, 20, 3))
    ops.pairwise_dist_batch(X)
    ops.knn_graph_batch(X, k=3)
    ops.masked_argmin(torch.zeros(2, 20), torch.zeros(2, 20,
                                                      dtype=torch.bool))
    aux = ops.metric_aux(X)
    ops.prim_persist(X, aux, torch.tensor([0, 1]))
    ops.prim_stream_step(X, aux, torch.tensor([0, 1]),
                         torch.full((2, 20), np.inf),
                         torch.zeros(2, 20, dtype=torch.bool))
    assert _build.launch_counts() == dict.fromkeys(_build.LAUNCHES, 0)


@pytest.mark.parametrize("call", [
    lambda: pairwise_dist_batch_cuda(torch.zeros(2, 4, 3)),
    lambda: knn_graph_batch_cuda(torch.zeros(2, 4, 3), k=2),
    lambda: prim_stream_step_batch_cuda(
        torch.zeros(2, 4, 3), torch.zeros(2, 4), torch.zeros(2,
                                                             dtype=torch.int64),
        torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.bool)),
], ids=["pairwise_dist_batch", "knn_graph_batch", "prim_stream_step_batch"])
def test_batch_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()

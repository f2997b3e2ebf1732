"""The port's flashvat rung held against the JAX package's, on the CPU.

The same numpy inputs go through ``repro`` (its Pallas kernels in interpret
mode, or its XLA mirrors) and through ``repro_torch``, whose CPU path is the
plain PyTorch versions of its kernels (``kernels/ref.py``).  The CUDA
kernels themselves are held in ``test_torch_cuda.py`` on a GPU.

Tolerances: orders are compared exactly; distance values (rows, edges,
images) within the pairwise tolerances of ``test_torch_kernels.py`` — a
sqrt of the Gram cancellation floor for gram-form euclidean, 1e-5 of the
scale (+1e-6) otherwise — since the two frameworks round the cross term in
different places.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
from repro import core as jcore
from repro.core.vat import _streamed_seed_pivot as jseed
from repro.kernels import prim_persist as jpp
from repro.kernels import ref as jref
from repro_torch import FastVAT, core
from repro_torch.api import registry
from repro_torch.api.result import ResultMeta, TendencyResult
from repro_torch.core.vat import _streamed_seed_pivot
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.prim_persist import (persist_tile_bounds,
                                              prim_persist_cuda)
from repro_torch.kernels.prim_stream import prim_stream_step_cuda

F32_EPS = float(np.finfo(np.float32).eps)
FORMS = ("gram", "direct")


def _tolerance(metric, form, X, want):
    if metric == "euclidean" and form == "gram":
        sq = float(np.max(np.sum(np.float64(X) ** 2, axis=1)))
        return (16 * F32_EPS * sq) ** 0.5
    return 1e-5 * float(np.max(np.abs(want))) + 1e-6


def _points(n, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _int_blobs(n, d=8, k=4, seed=0):
    """Clusters on integer coordinates: every dot product, norm and
    squared distance is an exact f32 integer, so both frameworks compute
    every entry to the same bits, exact ties included."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, size=(k, d))
    return (centers[np.arange(n) % k]
            + rng.integers(-3, 4, size=(n, d))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------ the plain versions ----

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_prim_refs_match_jax_refs(metric, form):
    X = _points(70, d=6, seed=3)
    aux = ref.metric_aux_ref(_t(X), metric=metric)
    jaux = jref.metric_aux_ref(jnp.asarray(X), metric=metric)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-6,
                               atol=0)
    for q in (0, 33, 69):
        got = ref.pivot_row_ref(_t(X), aux, torch.tensor(q), metric=metric,
                                form=form).numpy()
        want = np.asarray(jref.pivot_row_ref(jnp.asarray(X), jaux, q,
                                             metric=metric, form=form))
        assert np.max(np.abs(got - want)) <= _tolerance(metric, form, X,
                                                        want)
    rng = np.random.default_rng(4)
    mind = (rng.random(70) * 3).astype(np.float32)
    sel = rng.random(70) < 0.4
    sel[5] = True
    m, ev, nq = ref.prim_stream_step_ref(_t(X), aux, torch.tensor(5),
                                         _t(mind), _t(sel), metric=metric,
                                         form=form)
    jm, jev, jnq = jref.prim_stream_step_ref(jnp.asarray(X), jaux, 5,
                                             jnp.asarray(mind),
                                             jnp.asarray(sel), metric=metric,
                                             form=form)
    assert np.max(np.abs(m.numpy() - np.asarray(jm))) <= _tolerance(
        metric, form, X, np.asarray(jm))
    assert int(nq) == int(jnq) and nq.dtype == torch.int64
    assert abs(float(ev) - float(jev)) <= _tolerance(metric, form, X,
                                                     np.asarray(jm))
    order, edges = ref.prim_persist_ref(_t(X), aux, torch.tensor(7),
                                        metric=metric, form=form)
    jorder, jedges = jref.prim_persist_ref(jnp.asarray(X), jaux, 7,
                                           metric=metric, form=form)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert np.max(np.abs(edges.numpy() - np.asarray(jedges))) <= _tolerance(
        metric, form, X, np.asarray(jedges))
    assert ref.UNSEEN == jref.UNSEEN


def test_prim_persist_ref_single_point():
    X = torch.ones(1, 3)
    order, edges = ref.prim_persist_ref(X, ref.metric_aux_ref(X), 0)
    assert order.tolist() == [0] and edges.tolist() == [0.0]
    res = core.vat_matrix_free(X)
    assert res.order.tolist() == [0] and res.edges.tolist() == [0.0]


@pytest.mark.parametrize("metric", ref.METRICS)
def test_tile_bounds_match_reference(metric):
    """The pruning geometry, unpadded here, padded in the reference."""
    X = _points(150, d=5, seed=8)
    cent, rad = persist_tile_bounds(_t(X), metric=metric, block=64)
    Xp, _, _, bn = jpp.pad_points(jnp.asarray(X), jnp.zeros(150), block=64)
    jcent, jrad = jpp.persist_tile_bounds(Xp, 150, metric=metric, block=bn)
    np.testing.assert_allclose(cent.numpy(), np.asarray(jcent)[:, :5],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- the seed scan ----

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_streamed_seed_matches_reference_and_matrix(metric, form):
    X = _points(300, d=4, seed=9)
    got = _streamed_seed_pivot(_t(X), metric=metric, form=form)
    assert got.dim() == 0 and got.dtype == torch.int64
    assert int(got) == int(jseed(jnp.asarray(X), metric=metric, form=form))
    R = ops.pairwise_dist(_t(X), metric=metric, form=form)
    assert int(got) == int(torch.argmax(torch.amax(R, dim=1)))


def test_seed_scan_blocks_stay_under_n(monkeypatch):
    """At the rung's top size the scan takes (2,048 x 8,192)-bounded
    blocks, 25 x 7 of them; at small n still at least two a side."""
    seen = []

    def fake(X, Y=None, **kw):
        seen.append((X.shape[0], None if Y is None else Y.shape[0]))
        return torch.zeros(X.shape[0], Y.shape[0])

    monkeypatch.setattr(ops, "pairwise_dist", fake)
    _streamed_seed_pivot(torch.zeros(50_000, 1), metric="euclidean")
    assert len(seen) == 175
    assert max(r for r, _ in seen) <= 2_048 and max(c for _, c in seen) <= 8_192
    seen.clear()
    _streamed_seed_pivot(torch.zeros(5, 1), metric="euclidean")
    assert seen and all(r < 5 and c < 5 for r, c in seen)


# ---------------------------------------------------- the two engines ----

@pytest.mark.parametrize("n", [64, 257])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_vat_matrix_free_matches_reference(metric, n):
    """Both engines against JAX vat_matrix_free and the Pallas megakernel
    in interpret mode: orders equal, edges within tolerance; the port's
    two engines agree bit for bit with each other."""
    X = _points(n, d=3 + n % 5, seed=n)
    turbo = core.vat_matrix_free(_t(X), metric=metric)
    stepw = core.vat_matrix_free(_t(X), metric=metric, turbo=False)
    np.testing.assert_array_equal(turbo.order.numpy(), stepw.order.numpy())
    np.testing.assert_array_equal(turbo.edges.numpy(), stepw.edges.numpy())
    want = jcore.vat_matrix_free(jnp.asarray(X), metric=metric)
    np.testing.assert_array_equal(turbo.order.numpy(), np.asarray(want.order))
    tol = _tolerance(metric, "gram", X, np.asarray(want.edges))
    assert np.max(np.abs(turbo.edges.numpy() - np.asarray(want.edges))) <= tol
    Xj = jnp.asarray(X)
    aux = jref.metric_aux_ref(Xj, metric=metric)
    korder, kedges, _ = jpp.prim_persist_pallas(
        Xj, aux, jseed(Xj, metric=metric), metric=metric, block=64,
        interpret=True)
    np.testing.assert_array_equal(turbo.order.numpy(), np.asarray(korder))
    assert np.max(np.abs(turbo.edges.numpy() - np.asarray(kedges))) <= tol


@pytest.mark.parametrize("n", [64, 257, 1024])
def test_flashvat_order_equals_vat_order(n):
    """Matrix-free and materialized orders of the port, on the CPU."""
    X = _points(n, d=4, seed=n + 5)
    got = core.vat_matrix_free(_t(X)).order
    np.testing.assert_array_equal(got.numpy(), core.vat(_t(X)).order.numpy())


def test_orders_identical_across_block_lengths():
    """The tile length changes the schedule's work, never the order: the
    reference's megakernel at three block lengths and the port's engine at
    the same three agree."""
    X = _points(300, d=3, seed=12)
    Xj = jnp.asarray(X)
    aux = jref.metric_aux_ref(Xj)
    i0 = jseed(Xj, metric="euclidean")
    orders = [np.asarray(jpp.prim_persist_pallas(Xj, aux, i0, block=b,
                                                 interpret=True)[0])
              for b in (64, 256, 1024)]
    orders += [core.vat_matrix_free(_t(X), block=b).order.numpy()
               for b in (64, 256, 1024)]
    for o in orders[1:]:
        np.testing.assert_array_equal(o, orders[0])


def test_matrix_free_direct_form_on_adversarial_data():
    from _numerics_data import adversarial
    from repro_torch.numerics import resolve
    X = adversarial("near_duplicates", n=96)
    for metric in ("euclidean", "manhattan"):
        Xc, rep = resolve(X, metric=metric)
        assert rep.form == "direct"
        got = core.vat_matrix_free(_t(Xc), metric=metric, form="direct")
        R = ops.pairwise_dist(_t(Xc), metric=metric, form="direct")
        np.testing.assert_array_equal(got.order.numpy(),
                                      core.vat_order(R).numpy())
        want = jcore.vat_matrix_free(jnp.asarray(Xc), metric=metric,
                                     form="direct")
        np.testing.assert_array_equal(got.order.numpy(),
                                      np.asarray(want.order))


def test_matrix_free_never_materializes_pairwise(monkeypatch):
    """No self call and no operand of n rows or more, as the reference's
    tripwire (tests/test_flashvat.py) demands."""
    real = ops.pairwise_dist
    n = 2_333

    def guarded(X, Y=None, **kw):
        if Y is None or X.shape[0] >= n or Y.shape[0] >= n:
            raise AssertionError("vat_matrix_free materialized a matrix")
        return real(X, Y, **kw)

    monkeypatch.setattr(ops, "pairwise_dist", guarded)
    order = core.vat_matrix_free(_t(_points(n, d=3, seed=4))).order
    assert sorted(order.tolist()) == list(range(n))


def test_cpu_prim_dispatch_launches_no_kernel():
    _build.reset_launch_counts()
    X = _t(_points(30, d=3))
    aux = ops.metric_aux(X)
    ops.prim_persist(X, aux, torch.tensor(0))
    ops.prim_stream_step(X, aux, torch.tensor(0), torch.full((30,), np.inf),
                         torch.zeros(30, dtype=torch.bool))
    assert _build.launch_counts() == dict.fromkeys(_build.LAUNCHES, 0)


@pytest.mark.parametrize("call", [
    lambda: prim_persist_cuda(torch.zeros(4, 2), torch.zeros(4),
                              torch.tensor(0)),
    lambda: prim_stream_step_cuda(torch.zeros(4, 2), torch.zeros(4),
                                  torch.tensor(0), torch.zeros(4),
                                  torch.zeros(4, dtype=torch.bool)),
], ids=["prim_persist", "prim_stream_step"])
def test_prim_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()


# ------------------------------------------------------------- the rung ----

@pytest.fixture(scope="module")
def fits_3000():
    X = _int_blobs(3000)
    got = FastVAT(method="flashvat", device="cpu").fit(X)
    want = repro.FastVAT(method="flashvat").fit(X)
    return X, got, want


def test_flashvat_fit_matches_reference(fits_3000):
    _, got, want = fits_3000
    res, wres = got.result, want.result
    assert got.method_resolved == "flashvat"
    np.testing.assert_array_equal(got.order(), want.order())
    np.testing.assert_array_equal(got.sample_indices(),
                                  want.sample_indices())
    np.testing.assert_array_equal(res.group_sizes.numpy(),
                                  np.asarray(wres.group_sizes))
    np.testing.assert_array_equal(res.extension_labels.numpy(),
                                  np.asarray(wres.extension_labels))
    assert res.rstar.shape == (256, 256)
    wr = np.asarray(wres.rstar)
    np.testing.assert_allclose(res.rstar.numpy(), wr, rtol=0,
                               atol=1e-5 * wr.max() + 1e-6)
    for use_ivat in (None, False, True):
        img = got.image(resolution=256, use_ivat=use_ivat)
        wimg = want.image(resolution=256, use_ivat=use_ivat)
        assert img.shape == (256, 256)
        np.testing.assert_allclose(img, wimg, rtol=0,
                                   atol=1e-5 * wimg.max() + 1e-6)


def test_flashvat_assess_matches_reference(fits_3000):
    _, got, want = fits_3000
    rep, wrep = got.assess(), want.assess()
    assert abs(rep.block_score - wrep.block_score) <= 1e-5
    assert rep.k_est == wrep.k_est == 4
    assert rep.clustered and wrep.clustered
    assert rep.method == "flashvat" and rep.n == 3000


def test_flashvat_float_data_within_tree_weight():
    """On float data the two frameworks round gram rows differently, and
    near-ties at the last bit may flip the order (ROADMAP queue 3); the
    orders are then held by spanning-tree weight, the reference's
    EXCESS_F32 = 1e-5.  What does not hang on those flips is held too: the
    band sizes exactly; the port's (m, m) matrix against the reference's
    dissimilarity of the port's own representatives, and against the
    reference's matrix where both fits picked the same representative,
    within the pairwise tolerance; and assess()'s k_est."""
    rng = np.random.default_rng(6)
    X = np.concatenate([rng.normal(size=(700, 6)) + c
                        for c in (0.0, 9.0, -9.0)]).astype(np.float32)
    got = FastVAT(method="flashvat", device="cpu").fit(X)
    want = repro.FastVAT(method="flashvat").fit(X)
    assert not got.result.meta.numerics.conditioned

    def weight(order):
        Y = np.float64(X[order])
        sq = np.sum(Y * Y, axis=1)
        d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * Y @ Y.T, 0))
        return float(np.sum(np.min(np.where(np.tri(len(Y), k=-1, dtype=bool),
                                            d, np.inf)[1:], axis=1)))

    w_got, w_want = weight(got.order()), weight(np.asarray(want.order()))
    assert abs(w_got - w_want) / w_want <= 1e-5
    np.testing.assert_array_equal(got.result.group_sizes.numpy(),
                                  np.asarray(want.result.group_sizes))
    rstar = got.result.rstar.numpy()
    idx = got.sample_indices()
    own = np.array(jref.pairwise_dissim_ref(jnp.asarray(X[idx])))
    np.fill_diagonal(own, 0.0)
    tol = _tolerance("euclidean", "gram", X, own)
    assert np.max(np.abs(rstar - own)) <= tol
    same = idx == np.asarray(want.sample_indices())
    ix = np.ix_(same, same)
    assert same.sum() >= 2
    assert np.max(np.abs(rstar[ix] - np.asarray(want.result.rstar)[ix])) <= tol
    rep, wrep = got.assess(), want.assess()
    assert rep.k_est == wrep.k_est == 3 and rep.clustered == wrep.clustered


def test_flashvat_options_and_round_trip():
    X = _int_blobs(700, seed=2)
    a = FastVAT(method="flashvat", sample_size=64, device="cpu").fit(X)
    b = FastVAT(method="flashvat", sample_size=64, turbo=False,
                device="cpu").fit(X)
    np.testing.assert_array_equal(a.order(), b.order())
    assert a.result.rstar.shape == (64, 64) and a.result.meta.sample_size == 64
    assert a.image(resolution=100).shape == (100, 100)
    assert FastVAT(device="cpu").fit(X).sample_indices() is None
    res = a.result
    moved = TendencyResult.from_arrays(
        res.order.numpy(), res.rstar.numpy(), res.ivat_image.numpy(),
        ResultMeta(method="flashvat", n=700, device="cpu", sample_size=64),
        sample_idx=res.sample_idx.numpy(),
        extension_labels=res.extension_labels.numpy(),
        group_sizes=res.group_sizes.numpy())
    np.testing.assert_array_equal(moved.image(), a.image())
    fv = FastVAT.from_result(moved, X)
    assert fv.sample_size == 64
    np.testing.assert_array_equal(fv.sample_indices(), a.sample_indices())
    assert fv.assess() == a.assess()


def test_flashvat_bf16_storage_runs_in_f32():
    """bf16 storage keeps the points as bfloat16 on the device; the rung
    casts them to f32, so the fit equals an f32 fit of the same values."""
    from repro_torch import NumericsPolicy
    X = _int_blobs(600, seed=3) / 4.0     # exact in bf16
    bf = FastVAT(method="flashvat", device="cpu",
                 numerics=NumericsPolicy(dtype="bf16")).fit(X)
    assert bf._X.dtype == torch.bfloat16
    assert bf.result.meta.numerics.dtype == "bf16"
    f32 = FastVAT(method="flashvat", device="cpu").fit(bf._X.float().numpy())
    np.testing.assert_array_equal(bf.order(), f32.order())


def test_auto_picks_flashvat_above_small_n():
    X = _points(registry.SMALL_N + 1, d=3, seed=1)
    fv = FastVAT(device="cpu").fit(X)
    assert fv.method_resolved == "flashvat"
    assert sorted(fv.order().tolist()) == list(range(registry.SMALL_N + 1))


def test_flashvat_rejects_precomputed():
    D = np.asarray(ops.pairwise_dist(_t(_points(20, d=2))))
    with pytest.raises(ValueError, match="does not accept"):
        FastVAT(method="flashvat", metric="precomputed", device="cpu").fit(D)
    assert not registry.get_rung("flashvat").supports_precomputed
    assert registry.select_method(3_000, precomputed=True) == "vat"

"""The port's core (vat, ivat, hopkins) and numerics held against the JAX
package's, on the CPU, on the same numpy inputs."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _numerics_data import ADVERSARIAL_NAMES, adversarial, grid_clusters
from repro import core as jcore
from repro.numerics import condition as jcond
from repro_torch import core
from repro_torch.core.hopkins import probe_count
from repro_torch.kernels import ops, ref
from repro_torch.numerics import condition as tcond


def _blobs(n, d=3, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, d))
    labels = np.arange(n) % k
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("n", [30, 200])
def test_vat_order_matches_reference(n):
    """Same matrix in, same order out (tie-free blobs)."""
    R = np.asarray(jcore.vat(jnp.asarray(_blobs(n, seed=n))).dist)
    got = core.vat_order(_t(R)).numpy()
    for use_pallas_argmin in (False, True):
        want = np.asarray(jcore.vat_order(
            jnp.asarray(R), use_pallas_argmin=use_pallas_argmin))
        np.testing.assert_array_equal(got, want)
    # the plain argmin injected by hand gives the same order too
    np.testing.assert_array_equal(
        core.vat_order(_t(R), argmin=ref.masked_argmin_ref).numpy(), got)


def _int_matrix(n, seed, d=3, span=3):
    """Squared distances of integer points: exact f32 integers with many
    ties (duplicate points give zero entries off the diagonal)."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-span, span + 1, size=(n, d)).astype(np.float32)
    return np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 40, 129])
def test_vat_prim_order_matches_reference_on_integer_data(n):
    """ops.vat_prim_order on a tie-heavy integer matrix == the reference's
    vat_order on the same matrix, bit for bit."""
    R = _int_matrix(n, seed=n)
    i0 = torch.argmax(torch.amax(_t(R), dim=1)).view(1)
    got = ops.vat_prim_order(_t(R), i0).numpy()
    want = np.asarray(jcore.vat_order(jnp.asarray(R)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(core.vat_order(_t(R)).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 90])
def test_vat_prim_order_equals_the_loop(n):
    """On float data: the one-call order == the loop of masked argmins
    (the plain argmin injected by hand), and a stack's lanes == their solo
    calls."""
    mats = [np.asarray(jcore.vat(jnp.asarray(_blobs(n, seed=s))).dist)
            if n > 1 else np.zeros((1, 1), np.float32) for s in range(3)]
    stack = _t(np.stack(mats))
    i0 = torch.argmax(torch.amax(stack, dim=2), dim=1)
    lanes = ops.vat_prim_order(stack, i0)
    assert lanes.shape == (3, n) and lanes.dtype == torch.int64
    np.testing.assert_array_equal(core.vat_order_batch(stack).numpy(),
                                  lanes.numpy())
    for z, R in enumerate(mats):
        solo = core.vat_order(_t(R))
        loop = core.vat_order(_t(R), argmin=ref.masked_argmin_ref)
        assert torch.equal(solo, loop) and torch.equal(lanes[z], solo)
        assert sorted(solo.tolist()) == list(range(n))


@pytest.mark.parametrize("metric", ref.METRICS)
def test_vat_matches_reference(metric):
    X = _blobs(120, d=4, seed=3)
    res = core.vat(_t(X), metric=metric)
    want = jcore.vat(jnp.asarray(X), metric=metric, use_pallas=True)
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(want.order))
    scale = float(np.max(np.asarray(want.rstar)))
    np.testing.assert_allclose(res.rstar.numpy(), np.asarray(want.rstar),
                               rtol=0, atol=1e-5 * scale + 1e-6)
    # reorder is exact on the same inputs
    np.testing.assert_array_equal(
        core.reorder(_t(want.dist), _t(want.order)).numpy(),
        np.asarray(jcore.reorder(want.dist, want.order)))


def test_vat_from_dist_precomputed():
    rng = np.random.default_rng(11)
    P = rng.random((50, 50)).astype(np.float32)
    D = (P + P.T) * (1 - np.eye(50, dtype=np.float32))
    Dt = _t(D)
    res = core.vat_from_dist(Dt)
    want = jcore.vat_from_dist(jnp.asarray(D))
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(res.rstar.numpy(), np.asarray(want.rstar))
    assert res.dist is Dt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_structure_score_matches_reference(seed):
    rstar = np.asarray(jcore.vat(jnp.asarray(_blobs(150, k=3 + seed,
                                                    seed=seed))).rstar)
    score, k_est = core.block_structure_score(_t(rstar))
    wscore, wk = jcore.block_structure_score(jnp.asarray(rstar))
    assert abs(float(score) - float(wscore)) <= 1e-5
    assert int(k_est) == int(wk)
    s2, k2 = core.block_structure_score(_t(rstar), threshold=0.8)
    w2, wk2 = jcore.block_structure_score(jnp.asarray(rstar), threshold=0.8)
    assert abs(float(s2) - float(w2)) <= 1e-5 and int(k2) == int(wk2)


def test_ivat_matches_reference():
    X = _blobs(180, seed=5)
    R = np.asarray(jcore.vat(jnp.asarray(X)).dist)
    img, res = core.ivat(_t(R))
    wimg, wres = jcore.ivat(jnp.asarray(R), use_pallas=True)
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(wres.order))
    np.testing.assert_array_equal(img.numpy(), np.asarray(wimg))
    np.testing.assert_array_equal(
        core.ivat_from_vat(res.rstar).numpy(),
        np.asarray(jcore.ivat_from_vat(wres.rstar)))


@pytest.mark.parametrize("m", [0, 17])
def test_hopkins_with_reference_draws(m):
    """The JAX draws (split as in repro/core/hopkins.py) handed to the
    port's statistic give the JAX statistic."""
    X = _blobs(300, d=5, seed=9)
    key = jax.random.PRNGKey(4)
    n, d = X.shape
    mm = probe_count(n, m)
    k_samp, k_unif = jax.random.split(key)
    Xj = jnp.asarray(X)
    U = jax.random.uniform(k_unif, (mm, d), dtype=Xj.dtype,
                           minval=jnp.min(Xj, axis=0),
                           maxval=jnp.max(Xj, axis=0))
    idx = jax.random.choice(k_samp, n, (mm,), replace=False)
    got = float(core.hopkins_from_draws(_t(X), _t(U), _t(idx)))
    want = float(jcore.hopkins(Xj, key, m=m))
    assert got == pytest.approx(want, rel=1e-5)


def test_hopkins_generator_draws():
    X = _t(_blobs(300, d=5, seed=9))
    h1 = float(core.hopkins(X, torch.Generator().manual_seed(1)))
    h2 = float(core.hopkins(X, torch.Generator().manual_seed(1)))
    assert h1 == h2 and 0.75 < h1 < 1.0      # clustered, repeatable
    U, idx = core.hopkins_draws(X, torch.Generator().manual_seed(2), 30)
    assert U.shape == (30, 5) and len(set(idx.tolist())) == 30
    assert bool((U >= X.amin(0)).all() and (U <= X.amax(0)).all())
    rng = np.random.default_rng(0)
    uniform = _t(rng.random((400, 2)).astype(np.float32))
    assert 0.35 < float(core.hopkins(uniform,
                                     torch.Generator().manual_seed(0))) < 0.65


def _assert_resolve_equal(X, metric, mode="auto", dtype="f32"):
    got_X, got = tcond.resolve(X, metric=metric,
                               policy=tcond.NumericsPolicy(mode, dtype))
    want_X, want = jcond.resolve(X, metric=metric,
                                 policy=jcond.NumericsPolicy(mode, dtype))
    np.testing.assert_array_equal(got_X, want_X)
    assert got_X.dtype == want_X.dtype == np.float32
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("mode", ["fast", "safe", "auto"])
@pytest.mark.parametrize("name", ADVERSARIAL_NAMES)
def test_numerics_resolve_matches_reference(name, mode):
    X = adversarial(name, n=64)
    for metric in ("euclidean", "manhattan", "cosine"):
        for dtype in ("f32", "bf16"):
            _assert_resolve_equal(X, metric, mode, dtype)


@pytest.mark.parametrize("offset", [0.0, 1000.0, 1.0e6])
def test_numerics_conditioning_bitwise(offset):
    X = grid_clusters(offset=offset)
    np.testing.assert_array_equal(tcond.condition_transform(X),
                                  jcond.condition_transform(X))
    np.testing.assert_array_equal(tcond._quantize_bf16(X),
                                  jcond._quantize_bf16(X))
    assert dataclasses.astuple(tcond.condition_stats(X)) == \
        dataclasses.astuple(jcond.condition_stats(X))
    _assert_resolve_equal(X, "euclidean")
    assert tcond.KAPPA_SAFE == jcond.KAPPA_SAFE
    assert tcond.lb_slack_ulps("gram") == jcond.lb_slack_ulps("gram")


def test_numerics_policy_validation():
    with pytest.raises(ValueError, match="numerics mode"):
        tcond.NumericsPolicy(mode="fastest")
    with pytest.raises(TypeError):
        tcond.as_policy(3)
    assert tcond.as_policy("safe") == tcond.NumericsPolicy(mode="safe")
    with pytest.raises(ValueError, match="form must be one of"):
        ops.pairwise_dist(torch.zeros(3, 2), form="fast")

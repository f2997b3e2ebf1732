"""The port's evaluation tools (paper Tables 2-3 and its PCA / t-SNE
pictures) held on the CPU against the JAX package.

* ``data/synth.py``: the reference's datasets bit for bit.
* ``kmeans_from`` from the reference's maximin start: the same labels; the
  centres and the inertia within f32 tolerance (the one-hot product sums
  in another order).
* ``dbscan``: the reference's partition, by ARI (a point at the eps
  boundary may fall either side of a last-bit difference).
* ``adjusted_rand_index`` (numpy) exactly; ``pca`` up to each component's
  sign.
* t-SNE is chaotic over hundreds of steps and ``jax.random.normal`` cannot
  be drawn in torch, so: ``_cond_probs`` on one matrix within 1e-6
  (entries are at most 1); five steps of ``tsne_from`` from the reference's
  initial embedding on integer data (equal distance matrices) within
  1e-5 of the embedding's scale; full runs by the reference's own bars.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro.core.tsne import _cond_probs as jcond_probs
from repro.data import synth as jsynth
from repro_torch import core
from repro_torch.core.cluster import _dbscan
from repro_torch.core.tsne import _cond_probs
from repro_torch.data import synth
from repro_torch.kernels import ops

F32_EPS = float(np.finfo(np.float32).eps)

#: DBSCAN radius and k-means k per dataset, the reference's
#: benchmarks/vat_tables.py ``_EPS`` and ``_K``.
EPS = {"iris": 0.6, "mall": 10.0, "spotify": 1.6, "blobs": 0.8,
       "moons": 0.12, "circles": 0.12, "gmm": 0.45}
K = {"iris": 3, "mall": 5, "spotify": 4, "blobs": 3, "moons": 2,
     "circles": 2, "gmm": 3}


def _start(n, seed=0):
    """The reference's maximin start for ``jax.random.PRNGKey(seed)``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))


# ------------------------------------------------------------ datasets ----

def test_dataset_names_match_reference():
    assert synth.DATASETS == jsynth.DATASETS


@pytest.mark.parametrize("name", jsynth.DATASETS)
@pytest.mark.parametrize("seed", [0, 3])
def test_make_dataset_matches_reference(name, seed):
    X, y = synth.make_dataset(name, seed)
    Xw, yw = jsynth.make_dataset(name, seed)
    assert X.dtype == np.float32
    np.testing.assert_array_equal(X, Xw)
    if yw is None:
        assert y is None
    else:
        np.testing.assert_array_equal(y, yw)
        assert y.dtype == np.int32


def test_make_dataset_unknown_name():
    with pytest.raises(KeyError):
        synth.make_dataset("nope")


@pytest.mark.parametrize("kw", [{}, {"n": 7_001, "k": 3, "d": 4, "seed": 2,
                                     "scale": 0.5}])
def test_make_big_blobs_matches_reference(kw):
    X, y = synth.make_big_blobs(**kw)
    Xw, yw = jsynth.make_big_blobs(**kw)
    np.testing.assert_array_equal(X, Xw)
    np.testing.assert_array_equal(y, yw)


# -------------------------------------------------------------- k-means ----

@pytest.mark.parametrize("name", ["blobs", "circles", "gmm", "iris", "mall"])
def test_kmeans_from_matches_reference(name):
    X, _ = synth.make_dataset(name)
    key = jax.random.PRNGKey(0)
    wl, wc, wi = jcore.kmeans(jnp.asarray(X), key, k=K[name])
    gl, gc, gi = core.kmeans_from(torch.from_numpy(X), _start(len(X)),
                                  k=K[name])
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    scale = float(np.abs(X).max())
    assert np.abs(gc.numpy() - np.asarray(wc)).max() <= 64 * F32_EPS * scale
    assert float(gi) == pytest.approx(float(wi), rel=1e-5)
    assert gl.dtype == torch.int64 and gc.shape == (K[name], X.shape[1])


def test_kmeans_generator_draws_the_start():
    X, y = synth.make_dataset("blobs")
    Xt = torch.from_numpy(X)
    gen = torch.Generator().manual_seed(4)
    i0 = torch.randint(0, len(X), (), generator=torch.Generator()
                       .manual_seed(4))
    a = core.kmeans(Xt, gen, k=3)
    b = core.kmeans_from(Xt, i0, k=3)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_kmeans_recovers_blobs():
    X, y = synth.make_dataset("blobs")
    labels, _, inertia = core.kmeans(torch.from_numpy(X),
                                     torch.Generator().manual_seed(0), k=3)
    assert core.adjusted_rand_index(labels, y) > 0.95
    assert float(inertia) > 0


# --------------------------------------------------------------- DBSCAN ----

@pytest.mark.parametrize("name", jsynth.DATASETS)
def test_dbscan_matches_reference(name):
    X, _ = synth.make_dataset(name)
    want = np.asarray(jcore.dbscan(jnp.asarray(X), eps=EPS[name], min_pts=5))
    got = core.dbscan(torch.from_numpy(X), eps=EPS[name], min_pts=5)
    assert got.dtype == torch.int64
    assert core.adjusted_rand_index(got, want) >= 0.99
    # labels are core-point indices, noise -1, in both packages
    g = got.numpy()
    assert set(np.unique(g[g >= 0])) <= set(range(len(X)))


def test_dbscan_sweeps_to_the_fixpoint():
    """A chain of 30 points 1 apart: the least label walks one hop a sweep
    along the 28 core points, so 27 sweeps change it and the 28th does
    not; the two ends are border points of the one cluster."""
    X = np.stack([np.arange(30.0), np.zeros(30)], 1).astype(np.float32)
    labels, sweeps = _dbscan(torch.from_numpy(X), 1.1, 3)
    want = np.asarray(jcore.dbscan(jnp.asarray(X), eps=1.1, min_pts=3))
    np.testing.assert_array_equal(labels.numpy(), want)
    assert sweeps == 28
    assert (labels.numpy() == 1).all()


def test_kmeans_fails_on_circles_dbscan_succeeds():
    """The paper's headline qualitative comparison (Table 3, Circles)."""
    X, y = synth.make_dataset("circles")
    Xt = torch.from_numpy(X)
    km, _, _ = core.kmeans(Xt, torch.Generator().manual_seed(0), k=2)
    db = core.dbscan(Xt, eps=0.12, min_pts=5)
    ari_km = core.adjusted_rand_index(km, y)
    ari_db = core.adjusted_rand_index(db, y)
    assert ari_db > 0.95 > ari_km + 0.5


def test_dbscan_moons():
    X, y = synth.make_dataset("moons")
    db = core.dbscan(torch.from_numpy(X), eps=0.12, min_pts=5)
    assert core.adjusted_rand_index(db, y) > 0.9


def test_dbscan_labels_noise():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(scale=0.05, size=(50, 2)),
                        np.array([[5.0, 5.0]])]).astype(np.float32)
    db = core.dbscan(torch.from_numpy(X), eps=0.3, min_pts=5).numpy()
    assert db[-1] == -1          # the far outlier is noise
    assert len(set(db[:50].tolist())) == 1


# ------------------------------------------------------------ ARI, PCA ----

def test_ari_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(5):
        a = rng.integers(-1, 4, 300)
        b = np.where(rng.random(300) < 0.7, a, rng.integers(-1, 6, 300))
        assert core.adjusted_rand_index(a, b) == \
            jcore.adjusted_rand_index(a, b)
        assert core.adjusted_rand_index(torch.from_numpy(a), b) == \
            jcore.adjusted_rand_index(a, b)


def test_ari_properties():
    a = np.array([0, 0, 1, 1, 2, 2])
    assert core.adjusted_rand_index(a, a) == pytest.approx(1.0)
    perm = np.array([5, 5, 3, 3, 9, 9])   # same partition, renamed
    assert core.adjusted_rand_index(a, perm) == pytest.approx(1.0)
    rng = np.random.default_rng(0)
    b = rng.integers(0, 3, 600)
    c = rng.integers(0, 3, 600)
    assert abs(core.adjusted_rand_index(b, c)) < 0.05   # ~0 for random


def test_pca_matches_reference_up_to_sign():
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(100, 5)) * np.array([10, 5, 1, .1, .01])
         + 3.0).astype(np.float32)
    got = core.pca(torch.from_numpy(X), k=3).numpy()
    want = np.asarray(jcore.pca(jnp.asarray(X), k=3))
    assert got.shape == (100, 3)
    for j in range(3):
        sign = np.sign(np.dot(got[:, j], want[:, j]))
        np.testing.assert_allclose(sign * got[:, j], want[:, j], rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_pca_shape_and_variance_order():
    rng = np.random.default_rng(0)
    X = torch.from_numpy((rng.normal(size=(100, 5))
                          * np.array([10, 5, 1, .1, .01])).astype(np.float32))
    P = core.pca(X, k=2)
    assert P.shape == (100, 2)
    v = np.var(P.numpy(), axis=0)
    assert v[0] >= v[1]


def test_full_f32_turns_tf32_off_and_restores_the_callers_setting():
    """The evaluation tools' products run without TF32 inside
    ``full_f32`` whatever the process set, and the caller's setting is
    back after the block, also when the block raises."""
    from repro_torch.kernels.ref import full_f32
    m = torch.backends.cuda.matmul
    attr, on, off = (("fp32_precision", "tf32", "ieee")
                     if hasattr(m, "fp32_precision")
                     else ("allow_tf32", True, False))
    saved = getattr(m, attr)
    try:
        setattr(m, attr, on)
        with full_f32():
            assert getattr(m, attr) == off
        assert getattr(m, attr) == on
        with pytest.raises(KeyError):
            with full_f32():
                raise KeyError
        assert getattr(m, attr) == on
    finally:
        setattr(m, attr, saved)


# ---------------------------------------------------------------- t-SNE ----

def _two_clusters(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(scale=0.3, size=(40, 10)),
        rng.normal(scale=0.3, size=(40, 10)) + 4.0]).astype(np.float32)


@pytest.mark.parametrize("perplexity", [5.0, 15.0, 30.0])
def test_cond_probs_matches_reference(perplexity):
    X = synth.make_dataset("spotify")[0][:150]
    D = ops.pairwise_dist(torch.from_numpy(X))
    D2 = (D * D).numpy()
    got = _cond_probs(torch.from_numpy(D2), perplexity).numpy()
    want = np.asarray(jcond_probs(jnp.asarray(D2), perplexity))
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    assert (np.diag(got) == 0).all()


def test_tsne_from_matches_reference_five_steps():
    """From the reference's initial embedding, on integer points (so both
    packages start from the same distance matrix), five steps of early
    exaggeration agree within 1e-5 of the embedding's scale."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.integers(-2, 3, size=(40, 6)),
                        rng.integers(-2, 3, size=(40, 6)) + 9]
                       ).astype(np.float32)
    key = jax.random.PRNGKey(0)
    Y0 = np.array(1e-2 * jax.random.normal(key, (80, 2)))
    want = np.asarray(jcore.tsne(jnp.asarray(X), key, perplexity=15.0,
                                 iters=5))
    got = core.tsne_from(torch.from_numpy(X), torch.from_numpy(Y0),
                         perplexity=15.0, iters=5).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.mean(0), 0.0, atol=1e-5)


def test_tsne_separates_two_clusters():
    X = torch.from_numpy(_two_clusters())
    Y = core.tsne(X, torch.Generator().manual_seed(0), perplexity=15.0,
                  iters=300)
    assert Y.shape == (80, 2)
    assert bool(torch.all(torch.isfinite(Y)))
    a, b = Y[:40].numpy(), Y[40:].numpy()
    gap = np.linalg.norm(a.mean(0) - b.mean(0))
    spread = max(a.std(), b.std())
    assert gap > 2.0 * spread


def test_tsne_agrees_with_vat_on_spotify():
    """Paper §4.4.2: both t-SNE and VAT show no structure on spotify."""
    X, _ = synth.make_dataset("spotify")
    Y = core.tsne(torch.from_numpy(X[:150]), torch.Generator().manual_seed(0),
                  perplexity=20.0, iters=250)
    labels, _, _ = core.kmeans(Y, torch.Generator().manual_seed(1), k=2)
    Yn, ln = Y.numpy(), labels.numpy()
    a, b = Yn[ln == 0], Yn[ln == 1]
    gap = np.linalg.norm(a.mean(0) - b.mean(0))
    spread = max(a.std(), b.std())
    assert gap < 4.0 * spread  # clustered data shows >> this

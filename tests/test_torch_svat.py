"""The port's sVAT (maximin sampling and the VAT of the sample) held on the
CPU against the JAX package.

The reference draws its maximin start from a ``jax.random`` key and the
port from a ``torch.Generator``; the two give different numbers, so the
tests draw the start with the reference's key and hand it to the port's
``*_from`` forms.  Orders and sample indices are compared exactly; the
(s, s) matrices within the pairwise tolerance of ``test_torch_flashvat.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro import core as jcore
from repro_torch import FastVAT, core
from repro_torch.kernels import ref

F32_EPS = float(np.finfo(np.float32).eps)


def _start(n, seed=0):
    """The reference's maximin start for ``jax.random.PRNGKey(seed)``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))


def _three_blobs(n=300, d=2, sep=15.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n, d)),
                           rng.normal(size=(n, d)) + sep,
                           rng.normal(size=(n, d)) - sep]).astype(np.float32)


@pytest.mark.parametrize("metric", ref.METRICS)
def test_maximin_sample_matches_reference(metric):
    """The same start gives the reference's picks, index for index."""
    X = np.random.default_rng(3).normal(size=(300, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jcore.maximin_sample(jnp.asarray(X), 24, key,
                                           metric=metric))
    got = core.maximin_sample_from(torch.from_numpy(X), 24, _start(300),
                                   metric=metric)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_dissim_ref_matches_reference():
    from repro.kernels import ref as jref
    X = np.random.default_rng(4).normal(size=(50, 6)).astype(np.float32)
    for metric in ref.METRICS:
        got = ref.row_dissim_ref(torch.from_numpy(X), torch.from_numpy(X[7]),
                                 metric=metric).numpy()
        want = np.asarray(jref.row_dissim_ref(jnp.asarray(X),
                                              jnp.asarray(X[7]),
                                              metric=metric))
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(want) + 1e-6


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_svat_matches_reference(metric):
    """From the same start: the same sample, the same order of it, and the
    (s, s) image within the pairwise tolerance."""
    X = _three_blobs(seed=1)
    key = jax.random.PRNGKey(2)
    want = jcore.svat(jnp.asarray(X), key, s=48, metric=metric)
    got = core.svat_from(torch.from_numpy(X), _start(len(X), 2), s=48,
                         metric=metric)
    np.testing.assert_array_equal(got.sample_idx.numpy(),
                                  np.asarray(want.sample_idx))
    np.testing.assert_array_equal(got.vat.order.numpy(),
                                  np.asarray(want.vat.order))
    rstar = np.asarray(want.vat.rstar)
    tol = ((16 * F32_EPS * float(np.max(np.sum(np.float64(X) ** 2, 1))))
           ** 0.5 if metric == "euclidean" else 1e-5 * rstar.max() + 1e-6)
    assert np.max(np.abs(got.vat.rstar.numpy() - rstar)) <= tol


def test_svat_sample_is_valid_subset():
    """tests/test_core_extra.py:36-42, with a torch.Generator."""
    X = torch.from_numpy(np.random.default_rng(0).normal(
        size=(300, 3)).astype(np.float32))
    res = core.svat(X, torch.Generator().manual_seed(0), s=32)
    assert len(np.unique(res.sample_idx.numpy())) == 32
    assert res.vat.rstar.shape == (32, 32)
    assert sorted(res.vat.order.tolist()) == list(range(32))


def test_svat_preserves_block_structure():
    """tests/test_core_extra.py:45-53: three blobs keep three blocks."""
    res = core.svat(torch.from_numpy(_three_blobs()),
                    torch.Generator().manual_seed(0), s=48)
    score, k = core.block_structure_score(res.vat.rstar)
    assert float(score) > 0.6 and int(k) == 3


def test_maximin_covers_clusters():
    """tests/test_core_extra.py:56-63: six picks reach all three clusters,
    from every start."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(np.concatenate(
        [rng.normal(size=(100, 2)) + c for c in ([0, 0], [20, 0], [0, 20])]
    ).astype(np.float32))
    for seed in range(5):
        idx = core.maximin_sample(X, 6, torch.Generator().manual_seed(seed))
        assert set((idx // 100).tolist()) == {0, 1, 2}


def test_svat_rung_matches_reference_assessment():
    """``FastVAT(method="svat")``: the sample's order and (s, s) image, the
    sample's rows, and the reference's ``k_est``."""
    X = _three_blobs(seed=5)
    got = FastVAT(method="svat", sample_size=40, device="cpu").fit(X)
    want = repro.FastVAT(method="svat", sample_size=40).fit(X)
    assert got.method_resolved == "svat"
    assert got.image().shape == (40, 40) and got.order().shape == (40,)
    idx = got.sample_indices()
    assert idx.shape == (40,) and len(np.unique(idx)) == 40
    rep, wrep = got.assess(), want.assess()
    assert rep.k_est == wrep.k_est == 3
    assert rep.clustered and wrep.clustered and rep.method == "svat"

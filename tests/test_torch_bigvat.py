"""The port's Big-VAT rung held on the CPU against the JAX package.

Integer-coordinate points make every distance exact in both packages, so
ties are real (duplicated points, a prototype's own zero distance) and the
tie rules are compared, not the last bits: labels, the order and the group
sizes must be the reference's exactly.  The reference draws the maximin
start from a ``jax.random`` key and the port from a ``torch.Generator``,
so parity runs take the reference's start into ``bigvat_from``.  The
reference's shard_map pins have no counterpart here.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch import FastVAT, core
from repro_torch.api import registry
from repro_torch.kernels import ops as kops

# the modules (each package's ``core.bigvat`` name is the function)
jbig = importlib.import_module("repro.core.bigvat")
big = importlib.import_module("repro_torch.core.bigvat")


def _start(n, seed=0):
    """The reference's maximin start for ``jax.random.PRNGKey(seed)``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))


def _int_blobs(n, k=3, d=2, seed=0, sep=40, spread=3):
    """Integer points around k integer centres, with many duplicates."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-sep, sep, size=(k, d))
    lab = rng.integers(0, k, size=n)
    X = centers[lab] + rng.integers(-spread, spread + 1, size=(n, d))
    return X.astype(np.float32), lab.astype(np.int32)


def _blobs(n, k=3, d=2, seed=0, sep=40.0):
    rng = np.random.default_rng(seed)
    centers = (sep * rng.normal(size=(k, d))).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    X = centers[lab] + rng.normal(scale=1.0, size=(n, d)).astype(np.float32)
    return X.astype(np.float32), lab.astype(np.int32)


@pytest.mark.parametrize("block", [1, 512, 700])
def test_nearest_prototype_assign_matches_reference(block):
    """Ragged last block (700 = 512 + 188), one row a block, one block;
    integer data with equidistant prototypes, so first-index ties decide."""
    X, _ = _int_blobs(700, k=4, seed=1)
    P = np.concatenate([X[:12], X[3:5]])     # duplicated prototypes too
    want_lab, want_d = jbig.nearest_prototype_assign(X, P, block=block)
    got_lab, got_d = big.nearest_prototype_assign(
        torch.from_numpy(X), torch.from_numpy(P), block=block)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert got_lab.dtype == torch.int64 and got_d.dtype == torch.float32
    # the duplicated prototypes never win: the first index among equals does
    assert not np.isin(got_lab.numpy(), [12, 13]).any()


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_bigvat_from_matches_reference(metric):
    X, _ = _int_blobs(3_000, k=4, seed=2)
    want = jbig.bigvat(X, jax.random.PRNGKey(3), s=48, block=1_000,
                       metric=metric)
    got = big.bigvat_from(torch.from_numpy(X), _start(len(X), 3), s=48,
                          block=1_000, metric=metric)
    np.testing.assert_array_equal(got.sample.sample_idx.numpy(),
                                  np.asarray(want.sample.sample_idx))
    np.testing.assert_array_equal(got.sample.vat.order.numpy(),
                                  np.asarray(want.sample.vat.order))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.proto_dist.numpy(),
                                  np.asarray(want.proto_dist))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.group_sizes.numpy(),
                                  np.asarray(want.group_sizes))
    np.testing.assert_allclose(got.ivat.numpy(), np.asarray(want.ivat),
                               rtol=1e-6, atol=0)
    assert got.n == want.n and got.s == want.s == 48


def test_bigvat_order_ties_keep_index_order():
    """Within a group, equal distances (duplicates, the prototype's own
    zero) keep index order: the order is numpy's lexsort of the port's own
    labels and distances."""
    X, _ = _int_blobs(2_000, k=3, seed=4, spread=1)
    res = big.bigvat_from(torch.from_numpy(X), 5, s=16, block=300)
    rank = np.empty(16, np.int64)
    rank[res.sample.vat.order.numpy()] = np.arange(16)
    lab, dist = res.labels.numpy(), res.proto_dist.numpy()
    np.testing.assert_array_equal(res.order.numpy(),
                                  np.lexsort((dist, rank[lab])))
    assert (dist == 0).sum() > 16          # ties are real here
    own = res.sample.sample_idx.numpy()
    np.testing.assert_array_equal(dist[own], 0.0)


def test_smoothed_image_matches_reference():
    X, _ = _int_blobs(2_500, k=3, seed=5)
    want = jbig.bigvat(X, jax.random.PRNGKey(1), s=32)
    got = big.bigvat_from(torch.from_numpy(X), _start(len(X), 1), s=32)
    for use_ivat in (False, True):
        a = big.smoothed_image(got, 96, use_ivat=use_ivat)
        b = jbig.smoothed_image(want, 96, use_ivat=use_ivat)
        assert a.shape == (96, 96)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    plain = big.bigvat_from(torch.from_numpy(X), 0, s=32, compute_ivat=False)
    assert plain.ivat is None
    with pytest.raises(ValueError, match="compute_ivat"):
        big.smoothed_image(plain, use_ivat=True)


def test_bigvat_k_est_matches_exact_vat():
    X, _ = _blobs(600, k=3)
    Xt = torch.from_numpy(X)
    _, k_exact = core.block_structure_score(core.vat(Xt).rstar)
    res = core.bigvat(Xt, torch.Generator().manual_seed(0), s=64)
    _, k_big = core.block_structure_score(res.sample.vat.rstar)
    assert int(k_big) == int(k_exact) == 3


def test_bigvat_grouping_keeps_clusters_contiguous():
    X, lab = _blobs(2_000, k=4, seed=1)
    res = core.bigvat(torch.from_numpy(X), s=64)
    order = res.order.numpy()
    assert sorted(order.tolist()) == list(range(len(X)))
    assert 1 + int(np.sum(lab[order][1:] != lab[order][:-1])) == 4
    assert int(res.group_sizes.sum()) == len(X)
    score, _ = core.block_structure_score(
        torch.from_numpy(big.smoothed_image(res, resolution=128)))
    assert float(score) > 0.5


def test_tiled_pass_never_materializes_nxn(monkeypatch):
    """Every distance tile of the fit is at most (block, s), apart from the
    sample's own (s, s) matrix: nothing O(n^2), nothing O(n s)."""
    n, s, block = 20_000, 64, 4_096
    X, _ = _blobs(n, k=3, seed=3)
    shapes = []
    real = kops.pairwise_dist

    def recording(Xa, Ya=None, **kw):
        out = real(Xa, Ya, **kw)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(kops, "pairwise_dist", recording)
    res = big.bigvat_from(torch.from_numpy(X), 0, s=s, block=block)
    assert shapes[0] == (s, s)
    assert shapes[1:] == [(block, s)] * (n // block) + [(n % block, s)]
    want = torch.argmin(real(torch.from_numpy(X[:1000]),
                             torch.from_numpy(X[res.sample.sample_idx])),
                        dim=1)
    np.testing.assert_array_equal(res.labels[:1000].numpy(), want.numpy())


def test_bigvat_accepts_memmap(tmp_path):
    """Out-of-core input: a read-only np.memmap gives the ndarray's fit bit
    for bit, through the core function (on a tensor of the memmap), the
    block-streamed pass and the facade."""
    X, _ = _blobs(5_000, k=3, seed=4)
    path = tmp_path / "X.f32"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    ro = np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)
    a = big.bigvat_from(torch.tensor(np.asarray(ro)), 7, s=32, block=1024)
    b = big.bigvat_from(torch.from_numpy(X), 7, s=32, block=1024)
    for f in ("order", "labels", "proto_dist", "group_sizes"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    P = torch.from_numpy(X[:32])
    for got, want in zip(big.nearest_prototype_assign(ro, P, block=999),
                         big.nearest_prototype_assign(torch.from_numpy(X), P,
                                                      block=999)):
        assert torch.equal(got, want)
    fm = FastVAT(method="bigvat", sample_size=32, device="cpu").fit(ro)
    fa = FastVAT(method="bigvat", sample_size=32, device="cpu").fit(X)
    assert fm.result.meta.numerics is None
    np.testing.assert_array_equal(fm.order(), fa.order())
    assert torch.equal(fm.result.extension_labels, fa.result.extension_labels)
    assert torch.equal(fm.result.group_sizes, fa.result.group_sizes)


def test_fastvat_bigvat_rung_with_block(monkeypatch):
    """``FastVAT(method="bigvat", block=)``: the full-n order, the sample
    image expanded by group size, the report from the data's rows, and
    tiles of the asked block."""
    n = 12_000
    X, lab = _blobs(n, k=3, seed=0)
    shapes = []
    real = kops.pairwise_dist

    def recording(Xa, Ya=None, **kw):
        out = real(Xa, Ya, **kw)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(kops, "pairwise_dist", recording)
    fv = FastVAT(method="bigvat", sample_size=64, block=5_000,
                 device="cpu").fit(X)
    assert shapes == [(64, 64), (5_000, 64), (5_000, 64), (2_000, 64)]
    assert fv.method_resolved == "bigvat"
    order = fv.order()
    assert sorted(order.tolist()) == list(range(n))
    assert 1 + int(np.sum(lab[order][1:] != lab[order][:-1])) == 3
    assert fv.image(resolution=100).shape == (100, 100)
    assert fv.image(resolution=100, use_ivat=True).shape == (100, 100)
    assert len(fv.sample_indices()) == 64
    assert int(fv.result.group_sizes.sum()) == n
    rep = fv.assess()
    assert rep["method"] == "bigvat" and rep["k_est"] == 3
    assert rep["clustered"]
    # the same seed draws the same sample as the svat rung
    sv = FastVAT(method="svat", sample_size=64, device="cpu").fit(X)
    np.testing.assert_array_equal(sv.sample_indices(), fv.sample_indices())


def test_bigvat_report_agrees_with_reference():
    """Different draws, the same verdict: k_est and clustered as the
    reference's own bigvat fit reads them."""
    import repro
    X, _ = _blobs(8_000, k=4, seed=7)
    got = FastVAT(method="bigvat", sample_size=64, device="cpu").fit(X)
    want = repro.FastVAT(method="bigvat", sample_size=64).fit(X)
    g, w = got.assess(), want.assess()
    assert (g["k_est"], g["clustered"]) == (w["k_est"], w["clustered"])


def test_only_embed_is_unported():
    # the embed rung is ported too: nothing of the reference is left out
    assert registry.UNPORTED == ()
    assert "embed" in registry.registered()
    assert "bigvat" in registry.registered()
    assert registry.get_rung("bigvat").auto_threshold is None
    assert registry.RungOptions().block == big.DEFAULT_BLOCK == 4096
    assert FastVAT(device="cpu").block == big.DEFAULT_BLOCK

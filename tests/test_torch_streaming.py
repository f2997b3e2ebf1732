"""The port's StreamingVAT held on the CPU against the JAX package.

Every case of ``tests/test_streaming.py`` runs through both packages on the
same chunks: the reservoir (``pts``, ``counts``, ``n_seen``) is host numpy
in both and must be the reference's bit for bit; the port's ``order()`` must
be its own batch VAT of that reservoir bit for bit, and the reference's
order wherever the two packages' matrices give it (integer-free float data
can part at a last-bit near-tie, so the cross-package order is held by
spanning-tree weight).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as jcore
from repro.core.streaming import StreamingVAT as JStreamingVAT
from repro_torch import core
from repro_torch.api.validation import InvalidInput
from repro_torch.core.streaming import StreamingVAT
from repro_torch.kernels.ref import METRICS, pairwise_dissim_ref

F32_EPS = float(np.finfo(np.float32).eps)


def _both(cap, d, chunks, **kw):
    """Feed the same chunks to both packages' streams; assert the reservoirs
    agree bit for bit after every chunk; return (port, reference)."""
    got = StreamingVAT(cap=cap, d=d, device="cpu", **kw)
    want = JStreamingVAT(cap=cap, d=d, **kw)
    for c in chunks:
        got.update(c)
        want.update(c)
        np.testing.assert_array_equal(got.pts, want.pts)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.n_seen == want.n_seen
    return got, want


def _tree_weight(pts, order, metric):
    """Spanning-tree weight of a VAT order (each vertex's least
    dissimilarity to the vertices before it), in f64."""
    R = pairwise_dissim_ref(torch.from_numpy(pts).double(),
                            metric=metric).numpy()
    o = np.asarray(order)
    return sum(R[o[i], o[:i]].min() for i in range(1, len(o)))


def _orders_agree(got, want, metric="euclidean"):
    """The port's order is its own batch VAT bit for bit, and the
    reference's, or within EXCESS_F32 of its tree weight."""
    mine = core.vat(torch.from_numpy(got.pts), metric=metric).order.numpy()
    np.testing.assert_array_equal(got.order(), mine)
    theirs = want.order()
    if not np.array_equal(got.order(), theirs):
        a = _tree_weight(got.pts, got.order(), metric)
        b = _tree_weight(got.pts, theirs, metric)
        assert abs(a - b) <= 1e-5 * b


def test_reservoir_bounded_and_exact():
    rng = np.random.default_rng(0)
    got, want = _both(64, 3, [rng.normal(size=(50, 3)) for _ in range(10)])
    assert len(got.pts) == 64
    assert got.n_seen == 500
    _orders_agree(got, want)
    np.testing.assert_array_equal(got.order(), np.asarray(
        jcore.vat(jnp.asarray(want.pts)).order))


def test_streaming_detects_emerging_clusters():
    rng = np.random.default_rng(1)
    first = rng.normal(size=(200, 2))
    second = rng.normal(size=(200, 2)) + 12.0
    got, want = _both(96, 2, [first])
    _, score1, _ = got.tendency()
    _, wscore1, _ = want.tendency()
    got.update(second)
    want.update(second)
    np.testing.assert_array_equal(got.pts, want.pts)
    h2, score2, k2 = got.tendency()
    _, wscore2, wk2 = want.tendency()
    assert score2 > score1
    assert k2 >= 2 and k2 == wk2
    # block score is draw-free: the reference's within f32 tolerance
    assert score1 == pytest.approx(wscore1, rel=1e-5)
    assert score2 == pytest.approx(wscore2, rel=1e-5)
    assert 0.0 < h2 < 1.0
    # the Hopkins probes come from a generator seeded with n_seen
    assert got.tendency() == (h2, score2, k2)
    gen = torch.Generator().manual_seed(got.n_seen)
    assert got.tendency(gen)[0] == h2


def test_absorption_keeps_counts():
    got, _ = _both(4, 1, [np.array([[0.0], [1.0], [2.0], [3.0]]),
                          np.array([[0.001]] * 5)])
    assert len(got.pts) == 4
    assert got.counts.sum() == 9


def test_absorption_running_mean_exact():
    """The absorb path weights the slot mean by the OLD multiplicity."""
    got, _ = _both(2, 1, [np.array([[0.0], [8.0]]), np.array([[2.0]])])
    assert got.counts[0] == 2
    np.testing.assert_allclose(got.pts[0], [1.0])  # mean of {0, 2}
    got.update(np.array([[4.0]]))                 # absorbed again (|1-4|<7)
    assert got.counts[0] == 3
    np.testing.assert_allclose(got.pts[0], [2.0])  # mean of {0, 2, 4}
    np.testing.assert_allclose(got.pts[1], [8.0])
    assert got.counts[1] == 1


@pytest.mark.parametrize("metric", METRICS)
def test_streaming_metric_threads_end_to_end(metric):
    """The reservoir's VAT queries run in the stream's metric."""
    rng = np.random.default_rng(7)
    chunks = [rng.normal(size=(40, 4)) + rng.integers(0, 3) * 5.0
              for _ in range(6)]
    got, want = _both(48, 4, chunks, metric=metric)
    assert len(got.pts) == 48
    _orders_agree(got, want, metric)
    assert got.image().shape == (48, 48)


def test_streaming_metric_shapes_reservoir_geometry():
    """A cosine stream thins by angle: it absorbs same-direction points
    whatever their radius, where the euclidean reservoir keeps them."""
    rng = np.random.default_rng(3)
    angles = rng.uniform(0, 2 * np.pi, size=400)
    radii = rng.uniform(0.5, 20.0, size=400)
    X = np.stack([radii * np.cos(angles), radii * np.sin(angles)], 1)
    cos_sv, _ = _both(32, 2, [X], metric="cosine")
    euc_sv, _ = _both(32, 2, [X], metric="euclidean")
    assert cos_sv.counts.sum() > euc_sv.counts.sum()
    cos_angles = np.sort(np.arctan2(cos_sv.pts[:, 1], cos_sv.pts[:, 0]))
    gaps = np.diff(np.concatenate([cos_angles, cos_angles[:1] + 2 * np.pi]))
    assert gaps.max() < 6 * (2 * np.pi / 32)


def test_streaming_rejects_unknown_metric():
    with pytest.raises(ValueError, match="metric"):
        StreamingVAT(cap=8, d=2, metric="chebyshev", device="cpu")


def test_cosine_zero_norm_rejected_streaming():
    """``tests/test_numerics.py::test_cosine_zero_norm_rejected_streaming``:
    a chunk with a zero-norm row is refused whole under validate=True."""
    rng = np.random.default_rng(14)
    first = np.abs(rng.normal(size=(8, 4))).astype(np.float32) + 0.1
    chunk = rng.normal(size=(8, 4)).astype(np.float32)
    chunk[3] = 0.0
    sv = StreamingVAT(cap=16, d=4, metric="cosine", device="cpu")
    sv.update(first)
    n_before = len(sv.pts)
    with pytest.raises(InvalidInput) as ei:
        sv.update(chunk)
    assert ei.value.reason == "zero_norm"
    assert len(sv.pts) == n_before
    relaxed, _ = _both(16, 4, [chunk], metric="cosine", validate=False)
    assert relaxed.n_seen == 8


def test_queries_cache_until_update():
    rng = np.random.default_rng(5)
    sv = StreamingVAT(cap=32, d=2, device="cpu")
    sv.update(rng.normal(size=(64, 2)))
    first = sv._vat()
    assert sv._vat() is first
    sv.update(rng.normal(size=(1, 2)))
    assert sv._vat() is not first


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingVAT(cap=8, d=2)

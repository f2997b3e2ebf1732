"""The iVAT range route's plain stages (``repro_torch.kernels.ref``) held
against the JAX package's iVAT.

The card's iVAT op takes the range route for a lane in Prim order: the
parents (j, w) of every row, a route check, and D' written as a range
maximum of w; lanes that fail the check run the recurrence.  Here the plain
stages run on the CPU, composed as the card composes them, on VAT orders
made by ``repro``'s own ``vat`` from numpy inputs, and are compared with
``repro.core.ivat_from_vat`` and the Pallas kernel in interpret mode.
Comparisons are by value (``assert_array_equal``: -0.0 == +0.0), as the
range route writes every zero +0.0.  The CUDA stages are held against
these plain versions in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as jcore
from repro.kernels.ivat_update import ivat_from_vat_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ivat_update import (ivat_parents_cuda,
                                            ivat_range_cuda, ivat_route_cuda,
                                            ivat_serial_cuda)


def _blobs(n, seed, d=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=6.0, size=(4, d))
    return (centres[rng.integers(0, 4, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _ints(n, seed, d=2):
    """Integer coordinates on a small grid: many equal distances."""
    return np.random.default_rng(seed).integers(0, 5, (n, d)).astype(
        np.float32)


def _duplicates(n, seed, d=3):
    """Every point three times over: zero distances off the diagonal."""
    X = _blobs(-(-n // 3), seed, d)
    return np.repeat(X, 3, axis=0)[:n]


def _signed_matrix(n, seed):
    """A symmetric precomputed matrix with negative entries, +0.0 and
    -0.0 off the diagonal, and a zero diagonal."""
    rng = np.random.default_rng(seed)
    A = rng.integers(-3, 4, (n, n)).astype(np.float32)
    A = A + A.T
    A[A == 0] = np.where(rng.random(int((A == 0).sum())) < 0.5, 0.0, -0.0)
    np.fill_diagonal(A, 0.0)
    return A


def _vat_order(kind, n, seed):
    """A VAT-ordered matrix from repro's vat, as numpy."""
    if kind == "signed":
        return np.array(jcore.vat_from_dist(
            jnp.asarray(_signed_matrix(n, seed))).rstar)
    X = {"blobs": _blobs, "ints": _ints, "dups": _duplicates}[kind](n, seed)
    return np.array(jcore.vat(jnp.asarray(X)).rstar)


def _staged(rstar):
    """The plain stages composed as the card composes them: lanes the route
    check passes take the range writer, the rest the recurrence."""
    R = torch.from_numpy(rstar)
    R3 = R if R.dim() == 3 else R[None]
    j, w = ref.ivat_parents_ref(R3)
    D = ref.ivat_range_ref(w)
    for z in torch.nonzero(~ref.ivat_route_ref(j, w)).flatten().tolist():
        D[z] = ref.ivat_from_vat_ref(R3[z])
    return (D if R.dim() == 3 else D[0]).numpy()


KINDS = ("blobs", "ints", "dups", "signed")


@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 200])
@pytest.mark.parametrize("kind", KINDS)
def test_staged_equals_reference(kind, n):
    rstar = (_vat_order(kind, n, seed=n) if n > 1
             else np.zeros((1, 1), np.float32))
    j, w = ref.ivat_parents_ref(torch.from_numpy(rstar))
    assert bool(ref.ivat_route_ref(j, w))
    got = _staged(rstar)
    np.testing.assert_array_equal(
        got, np.asarray(jcore.ivat_from_vat(jnp.asarray(rstar))))
    np.testing.assert_array_equal(
        got, np.asarray(ivat_from_vat_pallas(jnp.asarray(rstar),
                                             interpret=True)))
    # the range writer alone writes every zero +0.0 and a zero diagonal
    D = ref.ivat_range_ref(w).numpy()
    assert not np.signbit(D).any()
    np.testing.assert_array_equal(D, D.T)


@pytest.mark.parametrize("kind", KINDS)
def test_route_true_on_every_vat_stack(kind):
    stack = np.stack([_vat_order(kind, 90, seed=s) for s in range(4)])
    j, w = ref.ivat_parents_ref(torch.from_numpy(stack))
    assert j.shape == w.shape == (4, 90) and j.dtype == torch.int32
    assert ref.ivat_route_ref(j, w).tolist() == [True] * 4
    got = _staged(stack)
    np.testing.assert_array_equal(
        got, np.asarray(ivat_from_vat_pallas(jnp.asarray(stack),
                                             interpret=True)))
    for z in range(4):
        np.testing.assert_array_equal(got[z], _staged(stack[z]))


def test_parents_are_the_recurrence_parents():
    """j is the first-index argmin of each row's prefix (the argmin_key
    order: -0.0 ties +0.0), w that entry with its own bits."""
    rstar = _vat_order("signed", 70, seed=3)
    j, w = ref.ivat_parents_ref(torch.from_numpy(rstar))
    assert int(j[0]) == 0 and float(w[0]) == -np.inf
    for r in range(1, 70):
        row = rstar[r, :r]
        want = int(np.flatnonzero(row == row.min())[0])
        assert int(j[r]) == want
        assert np.float32(w[r]).tobytes() == rstar[r, want].tobytes()


def _swapped(rstar, p):
    perm = np.arange(rstar.shape[0])
    perm[[p, p + 1]] = perm[[p + 1, p]]
    return np.ascontiguousarray(rstar[perm][:, perm])


@pytest.mark.parametrize("kind", ["blobs", "ints"])
def test_route_false_on_swapped_rows(kind):
    """Two neighbouring rows of a VAT order swapped: where that breaks the
    condition the check says so, and the composed stages (the serial
    route for that lane) still equal the reference."""
    rstar = _vat_order(kind, 60, seed=11)
    broken = 0
    for p in range(1, 59):
        R2 = _swapped(rstar, p)
        j, w = ref.ivat_parents_ref(torch.from_numpy(R2))
        if bool(ref.ivat_route_ref(j, w)):
            continue
        broken += 1
        np.testing.assert_array_equal(
            _staged(R2), np.asarray(jcore.ivat_from_vat(jnp.asarray(R2))))
    assert broken > 0


def test_route_false_on_a_near_tie_swap():
    """Two rows whose parent weights differ in the last bit, swapped: the
    check is exact and sends the lane to the recurrence."""
    X = np.array([[0.0], [1.0], [1.0 + 2 ** -20], [3.0], [3.0 + 2 ** -20]],
                 np.float32)
    rstar = np.array(jcore.vat(jnp.asarray(X)).rstar)
    j, w = ref.ivat_parents_ref(torch.from_numpy(rstar))
    assert bool(ref.ivat_route_ref(j, w))
    found = False
    for p in range(1, 4):
        R2 = _swapped(rstar, p)
        j2, w2 = ref.ivat_parents_ref(torch.from_numpy(R2))
        if not bool(ref.ivat_route_ref(j2, w2)):
            found = True
            np.testing.assert_array_equal(
                _staged(R2),
                np.asarray(jcore.ivat_from_vat(jnp.asarray(R2))))
    assert found


def test_route_false_on_nan():
    stack = np.stack([_vat_order("blobs", 50, seed=s) for s in range(3)])
    j, w = ref.ivat_parents_ref(torch.from_numpy(stack))
    for r in (1, 17, 49):
        w2 = w.clone()
        w2[1, r] = torch.nan
        assert ref.ivat_route_ref(j, w2).tolist() == [True, False, True]
    # a NaN entry that becomes a row's parent weight: the row's least key
    R = stack[2].copy()
    R[30, :] = np.float32(np.nan)
    R[:, 30] = R[30, :]
    j, w = ref.ivat_parents_ref(torch.from_numpy(R))
    assert bool(torch.isnan(w[30])) and not bool(ref.ivat_route_ref(j, w))


def test_range_is_the_path_maximum():
    """The range writer against its definition, entry by entry."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(2, 40)).astype(np.float32)
    w[:, 0] = -np.inf
    w[0, 5:9] = 0.0
    w[1, 3] = -0.0
    D = ref.ivat_range_ref(torch.from_numpy(w)).numpy()
    for z in range(2):
        for a in range(40):
            for c in range(40):
                lo, hi = min(a, c), max(a, c)
                want = max(0.0, w[z, lo + 1:hi + 1].max()) if hi > lo else 0.0
                assert D[z, a, c] == want
    assert not np.signbit(D).any()


def test_cpu_op_stays_the_recurrence():
    """The CPU dispatch of the op is the recurrence, the oracle of both
    routes."""
    rstar = _vat_order("ints", 80, seed=2)
    np.testing.assert_array_equal(
        ops.ivat_from_vat(torch.from_numpy(rstar)).numpy(),
        ref.ivat_from_vat_ref(torch.from_numpy(rstar)).numpy())


@pytest.mark.parametrize("call", [
    lambda: ivat_parents_cuda(torch.zeros(4, 4)),
    lambda: ivat_route_cuda(torch.zeros(1, 4, dtype=torch.int32),
                            torch.zeros(1, 4)),
    lambda: ivat_range_cuda(torch.zeros(1, 4), None,
                            torch.ones(1, dtype=torch.bool)),
    lambda: ivat_serial_cuda(torch.zeros(4, 4)),
])
def test_stage_wrappers_refuse_cpu_tensors(call):
    """Each stage wrapper raises on a CPU tensor before any build: the
    plain versions are the CPU's."""
    with pytest.raises(ValueError, match="CUDA"):
        call()

"""Admission of tensors and np.memmap input: the port against the JAX
package on the CPU.

A bfloat16 tensor is refused with the reference's typed error (its bf16
JAX arrays are refused so), or fitted as float32 under ``validate=False``;
np.memmap points skip the numerics pre-pass in ``fit`` (out-of-core input
stays uncopied), while ``fit_many`` stacks them first and conditions them,
as the reference does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.api.validation import InvalidInput as RefInvalidInput
from repro_torch.api.validation import InvalidInput


def _int_points(n=60, d=3, seed=0):
    """Integer coordinates: every dissimilarity is exact in f32 and in
    bf16, so the two packages' orders agree bit for bit."""
    rng = np.random.default_rng(seed)
    return rng.integers(-20, 20, size=(n, d)).astype(np.float32)


def _fit(pkg, entry, X, **kw):
    if pkg is repro_torch:
        kw["device"] = "cpu"
    fv = pkg.FastVAT(**kw)
    return fv.fit(X) if entry == "fit" else fv.fit_many(X)


def _bf16_inputs(entry):
    X = _int_points()
    if entry == "fit_many":
        X = np.stack([X, _int_points(seed=1)])
    return (jnp.asarray(X, jnp.bfloat16),
            torch.tensor(X, dtype=torch.bfloat16))


@pytest.mark.parametrize("entry", ["fit", "fit_many"])
def test_bf16_tensor_is_refused_like_the_reference(entry):
    ref_X, port_X = _bf16_inputs(entry)
    with pytest.raises(RefInvalidInput) as want:
        _fit(repro, entry, ref_X)
    with pytest.raises(InvalidInput) as got:
        _fit(repro_torch, entry, port_X)
    assert got.value.reason == want.value.reason == "dtype"
    assert str(got.value) == str(want.value) == (
        "X must be a real numeric array, got dtype bfloat16")


@pytest.mark.parametrize("entry", ["fit", "fit_many"])
def test_bf16_tensor_fits_without_validation(entry):
    ref_X, port_X = _bf16_inputs(entry)
    want = _fit(repro, entry, ref_X, validate=False)
    got = _fit(repro_torch, entry, port_X, validate=False)
    assert got.method_resolved == want.method_resolved == "vat"
    np.testing.assert_array_equal(got.order(), want.order())
    g, w = got.result.meta.numerics, want.result.meta.numerics
    assert (g.form, g.dtype, g.conditioned) == (w.form, w.dtype,
                                                w.conditioned)


def test_precomputed_and_memmap_bypass_the_prepass(tmp_path):
    """The counterpart of test_numerics.py's pin of the same name: no
    numerics report for a precomputed matrix nor for memmap points offset
    by 1e4 (ill-conditioned, but out-of-core), in either package."""
    X = _int_points(n=48)
    D = np.sqrt(np.sum((X[:, None] - X[None]) ** 2, axis=-1))
    for pkg in (repro, repro_torch):
        assert _fit(pkg, "fit", D,
                    metric="precomputed").result.meta.numerics is None
    mm = np.memmap(tmp_path / "pts.f32", dtype=np.float32, mode="w+",
                   shape=X.shape)
    mm[:] = X + 1.0e4
    mm.flush()
    for pkg in (repro, repro_torch):
        fv = _fit(pkg, "fit", mm, method="vat")
        assert fv.result.meta.numerics is None
        assert fv.order().shape == (48,)


def test_memmap_points_fit_in_gram_form_like_the_reference(tmp_path):
    """Well-conditioned memmap points: no pre-pass, the gram form, and the
    reference's order on the vat and flashvat rungs."""
    X = _int_points(n=64, d=4, seed=3)
    mm = np.memmap(tmp_path / "pts.f32", dtype=np.float32, mode="w+",
                   shape=X.shape)
    mm[:] = X
    mm.flush()
    for method in ("vat", "flashvat"):
        want = _fit(repro, "fit", mm, method=method)
        got = _fit(repro_torch, "fit", mm, method=method)
        assert got.result.meta.numerics is want.result.meta.numerics is None
        np.testing.assert_array_equal(got.order(), want.order())


def test_memmap_stack_is_conditioned_like_the_reference(tmp_path):
    """fit_many stacks its input into one f32 array first, so a memmap
    stack takes the pre-pass in both packages: offset by 1e4, both report
    the conditioned direct form."""
    Xs = np.stack([_int_points(n=48, seed=4), _int_points(n=48, seed=5)])
    mm = np.memmap(tmp_path / "stack.f32", dtype=np.float32, mode="w+",
                   shape=Xs.shape)
    mm[:] = Xs + 1.0e4
    mm.flush()
    want = _fit(repro, "fit_many", mm, method="vat").result.meta.numerics
    got = _fit(repro_torch, "fit_many", mm, method="vat").result.meta.numerics
    assert got is not None and want is not None
    assert (got.form, got.conditioned) == (want.form, want.conditioned) == (
        "direct", True)

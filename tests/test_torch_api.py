"""The port's public API (repro_torch.FastVAT and friends) held against the
JAX package's on the CPU, plus the port's own contracts: no JAX, a default
CUDA device, and a loud error for rungs not ported yet."""
import dataclasses
import doctest
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.api import facade, metrics, registry, result
from repro_torch.api.result import ResultMeta, TendencyResult

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _blobs(n=90, d=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0] * d, [9.0] * d, [-9.0] + [4.0] * (d - 1)])
    labels = np.arange(n) % 3
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


def _tol(a):
    return 1e-5 * float(np.max(np.abs(a))) + 1e-6


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan",
                                    "cosine"])
def test_fit_matches_reference(metric):
    X = _blobs(seed=1)
    got = repro_torch.FastVAT(metric=metric, device="cpu").fit(X)
    want = repro.FastVAT(metric=metric, use_pallas=True).fit(X)
    assert got.method_resolved == want.method_resolved == "vat"
    np.testing.assert_array_equal(got.order(), want.order())
    img, wimg = got.image(), want.image()
    assert img.shape == wimg.shape == (90, 90)
    np.testing.assert_allclose(img, wimg, rtol=0, atol=_tol(wimg))
    iv, wiv = got.image(use_ivat=True), want.image(use_ivat=True)
    np.testing.assert_allclose(iv, wiv, rtol=0, atol=_tol(wiv))
    rep, wrep = got.assess(), want.assess()
    assert abs(rep.block_score - wrep.block_score) <= 1e-5
    assert rep.k_est == wrep.k_est
    assert (rep.method, rep.metric, rep.n) == (wrep.method, wrep.metric,
                                               wrep.n)
    assert 0.0 < rep.hopkins < 1.0     # its draws differ from JAX's


def test_ivat_rung_and_precomputed_match_reference():
    X = _blobs(seed=2)
    got = repro_torch.FastVAT(method="ivat", device="cpu").fit(X)
    want = repro.FastVAT(method="ivat", use_pallas=True).fit(X)
    np.testing.assert_array_equal(got.order(), want.order())
    np.testing.assert_allclose(got.image(), want.image(), rtol=0,
                               atol=_tol(want.image()))
    D = np.asarray(repro.kernels.ops.pairwise_dist(X))
    gp = repro_torch.FastVAT(metric="precomputed", method="ivat",
                             device="cpu").fit(D)
    wp = repro.FastVAT(metric="precomputed", method="ivat").fit(D)
    np.testing.assert_array_equal(gp.order(), wp.order())
    np.testing.assert_array_equal(gp.image(), wp.image())   # no rounding
    rep, wrep = gp.assess(), wp.assess()
    assert np.isnan(rep.hopkins) and rep == dataclasses.replace(
        rep, hopkins=float("nan"))
    assert rep.clustered == wrep.clustered and rep.k_est == wrep.k_est


def test_from_arrays_runs_image_and_assess_on_a_reference_fit():
    """A JAX fit's fields, moved into the port: the port's image() and
    assess() on the very same fit."""
    X = _blobs(seed=3)
    want = repro.FastVAT().fit(X)
    res = want.result
    meta = ResultMeta(method="vat", n=X.shape[0], device="cpu")
    got = TendencyResult.from_arrays(np.asarray(res.order),
                                     np.asarray(res.rstar), None, meta)
    np.testing.assert_array_equal(got.image(), want.image())
    np.testing.assert_array_equal(got.image(use_ivat=True),
                                  want.image(use_ivat=True))
    port = repro_torch.FastVAT.from_result(got, X)
    rep, wrep = port.assess(), want.assess()
    assert abs(rep.block_score - wrep.block_score) <= 1e-5
    assert rep.k_est == wrep.k_est and rep.clustered == wrep.clustered


@pytest.mark.parametrize("case", ["nan", "too_few", "zero_norm", "flat",
                                  "dtype"])
def test_invalid_input_reasons_match_reference(case):
    metric = "cosine" if case == "zero_norm" else "euclidean"
    X = _blobs(seed=4)
    if case == "nan":
        X[3, 1] = np.nan
    elif case == "too_few":
        X = X[:3]
    elif case == "zero_norm":
        X[5] = 0.0
    elif case == "flat":
        X = np.ones((10, 3), np.float32)
    else:
        X = X.astype(np.complex64)
    with pytest.raises(repro.InvalidInput) as want:
        repro.FastVAT(metric=metric).fit(X)
    with pytest.raises(repro_torch.InvalidInput) as got:
        repro_torch.FastVAT(metric=metric, device="cpu").fit(X)
    assert got.value.reason == want.value.reason
    assert isinstance(got.value, ValueError)


def test_auto_above_small_n_names_the_missing_rung():
    # auto covers every n with ported rungs; an opt-in rung of the
    # reference that is not ported yet raises by name
    assert registry.select_method(10 ** 9) == "approx"
    for name in registry.UNPORTED:
        with pytest.raises(NotImplementedError, match=f"'{name}'"):
            repro_torch.FastVAT(method=name, device="cpu")
        with pytest.raises(NotImplementedError, match=f"'{name}'"):
            registry.get_rung(name)
    # precomputed input keeps the reference's exact-rung fallback
    assert registry.select_method(10 ** 6, precomputed=True) == "vat"


@pytest.mark.parametrize("n", [4, 2048, 2049, 50_000, 50_001, 10 ** 7])
def test_select_method_matches_reference(n):
    from repro.api import registry as jreg
    assert registry.select_method(n) == jreg.select_method(n)
    assert registry.select_method(n, precomputed=True) == \
        jreg.select_method(n, precomputed=True)
    assert registry.SMALL_N == jreg.SMALL_N
    assert registry.MEDIUM_N == jreg.MEDIUM_N


def test_default_device_is_cuda_and_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fv = repro_torch.FastVAT()
    assert fv.device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        fv.fit(_blobs())
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        repro_torch.assess_tendency(_blobs())
    meta = repro_torch.FastVAT(device="cpu").fit(_blobs()).result.meta
    assert meta.device == "cpu" and not hasattr(meta, "use_pallas")


def test_result_meta_seed_derivation():
    meta = ResultMeta(method="vat", seed=7, device="cpu")
    a = torch.rand(5, generator=meta.generator(1))
    b = torch.rand(5, generator=meta.generator(1))
    c = torch.rand(5, generator=meta.generator(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    want = repro.ResultMeta(method="vat", seed=7).host_rng(2).random(3)
    np.testing.assert_array_equal(meta.host_rng(2).random(3), want)
    X = _blobs(seed=5)
    r1 = repro_torch.FastVAT(device="cpu", seed=3).fit(X).assess()
    r2 = repro_torch.FastVAT(device="cpu", seed=3).fit(X).assess()
    assert r1 == r2


def test_numerics_plan_lands_on_meta():
    X = _blobs(seed=6) + 1.0e4     # uncentered: κ past KAPPA_SAFE
    got = repro_torch.FastVAT(device="cpu").fit(X)
    want = repro.FastVAT().fit(X)
    assert dataclasses.astuple(got.result.meta.numerics) == \
        dataclasses.astuple(want.result.meta.numerics)
    assert got.result.meta.numerics.form == "direct"
    np.testing.assert_array_equal(got.order(), want.order())
    bf = repro_torch.FastVAT(device="cpu", numerics=repro_torch.NumericsPolicy(
        dtype="bf16")).fit(_blobs(seed=6))
    assert bf.result.meta.numerics.dtype == "bf16"
    assert bf._X.dtype == torch.bfloat16


def test_doctests_pass():
    for mod in (facade, metrics, registry, result, repro_torch):
        failures, _ = doctest.testmod(mod, optionflags=doctest.ELLIPSIS)
        assert failures == 0, mod.__name__


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 15
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)


def test_port_runs_without_jax_subprocess():
    code = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.kernels import _build\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(40, 3)).astype(np.float32)\n"
        "fv = repro_torch.FastVAT(device='cpu').fit(X)\n"
        "fv.image(use_ivat=True); fv.assess()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert _build._LIB is None\n"
        "print('ok', fv.method_resolved)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok vat"


def test_api_exports_the_reference_names_subprocess():
    """``repro_torch.api`` exports what ``repro.api`` does (the old spelling
    ``from repro.api import METHODS`` switches to the port by renaming
    the package), and ``METHODS`` is the reference's on a fresh import:
    the rungs registered in the reference's order."""
    code = (
        "import repro.api as ref, repro_torch.api as port\n"
        "assert port.__all__ == ref.__all__, (port.__all__, ref.__all__)\n"
        "assert port.METHODS == ref.METHODS, (port.METHODS, ref.METHODS)\n"
        "assert port.FLASH_SHARD_MIN_N == ref.FLASH_SHARD_MIN_N\n"
        "print('ok', *port.METHODS)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["ok", "auto"]

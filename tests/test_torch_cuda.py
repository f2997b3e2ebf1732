"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips when
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor
``repro``, so it runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core.vat import vat
from repro_torch.kernels import ref
from repro_torch.kernels.ivat_update import ivat_from_vat_cuda
from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
from repro_torch.kernels.prim_update import masked_argmin_cuda

F32_EPS = float(np.finfo(np.float32).eps)
FORMS = ("gram", "direct")


def _tolerance(metric, form, X, Y, want):
    """A sqrt of the Gram cancellation floor for gram-form euclidean,
    1e-5 of the matrix scale (+1e-6) otherwise."""
    if metric == "euclidean" and form == "gram":
        sq = max(float(torch.amax(torch.sum(A.double() ** 2, dim=1)))
                 for A in (X, X if Y is None else Y))
        return (16 * F32_EPS * sq) ** 0.5
    return 1e-5 * float(torch.amax(torch.abs(want))) + 1e-6


def _argmin_cases(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-5, 6, size=n).astype(np.float32)   # many ties
    all_but_one = np.ones(n, bool)
    all_but_one[n // 3] = False
    return vals, {"random": rng.random(n) < 0.5, "none": np.zeros(n, bool),
                  "all_but_one": all_but_one, "all": np.ones(n, bool)}


def _vat_ordered(n, seed, device, d=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, d, generator=gen, device=device)
    X[n // 2:] += 5.0
    return vat(X).rstar


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_pairwise_against_plain(cuda, metric, form):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for n, m, d in ((301, None, 7), (200, 129, 70)):
        X = torch.randn(n, d, device=cuda, generator=gen)
        Y = None if m is None else torch.randn(m, d, device=cuda,
                                               generator=gen)
        got = pairwise_dist_cuda(X, Y, metric=metric, form=form)
        want = ref.pairwise_dissim_ref(X, Y, metric=metric, form=form)
        tol = _tolerance(metric, form, X, Y, want)
        assert float(torch.amax(torch.abs(got - want))) <= tol
        if Y is None:
            assert torch.equal(got, got.T)


@pytest.mark.cuda
def test_cuda_masked_argmin_bitwise(cuda):
    for n in (17, 4096, 4097, 20000):
        vals, masks = _argmin_cases(n, seed=n)
        v = torch.from_numpy(vals).to(cuda)
        for mask in masks.values():
            mk = torch.from_numpy(mask).to(cuda)
            kv, ki = masked_argmin_cuda(v, mk)
            pv, pi = ref.masked_argmin_ref(v, mk)
            assert int(ki) == int(pi)
            assert np.float32(kv.cpu()).tobytes() == \
                np.float32(pv.cpu()).tobytes()


@pytest.mark.cuda
def test_cuda_ivat_bitwise(cuda):
    for n in (1, 2, 65, 700):
        rstar = (_vat_ordered(n, n, cuda) if n > 1
                 else torch.zeros(1, 1, device=cuda))
        torch.testing.assert_close(ivat_from_vat_cuda(rstar),
                                   ref.ivat_from_vat_ref(rstar),
                                   rtol=0, atol=0)
    stack = torch.stack([_vat_ordered(90, s, cuda) for s in range(3)])
    batch = ivat_from_vat_cuda(stack)
    for lane in range(3):
        assert torch.equal(batch[lane], ivat_from_vat_cuda(stack[lane]))


@pytest.mark.cuda
def test_cuda_pairwise_bf16_storage(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    X = torch.randn(150, 33, device=cuda, generator=gen).bfloat16()
    for metric in ref.METRICS:
        got = pairwise_dist_cuda(X, metric=metric)
        want = ref.pairwise_dissim_ref(X, metric=metric)
        assert float(torch.amax(torch.abs(got - want))) <= _tolerance(
            metric, "gram", X.float(), None, want)


@pytest.mark.cuda
def test_cuda_fit_launches_every_kernel(cuda):
    from repro_torch import FastVAT
    from repro_torch.kernels import _build
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(100, 3)),
                        rng.normal(size=(100, 3)) + 8]).astype(np.float32)
    _build.reset_launch_counts()
    fv = FastVAT(method="ivat").fit(X)
    assert _build.launch_counts() == {"pairwise_dist": 1,
                                      "masked_argmin": 199,
                                      "ivat_from_vat": 1}
    assert fv.result.meta.device.startswith("cuda")
    assert fv.result.order.is_cuda and fv.result.ivat_image.is_cuda
    rep = fv.assess()
    assert rep.k_est == 2 and rep.clustered


@pytest.mark.cuda
def test_cuda_fit_on_a_device_that_is_not_current(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from repro_torch import FastVAT
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(100, 3)),
                        rng.normal(size=(100, 3)) + 8]).astype(np.float32)
    other = f"cuda:{torch.cuda.device_count() - 1}"
    assert torch.cuda.current_device() != int(other[5:])
    fv = FastVAT(device=other).fit(X)
    assert fv.result.order.device == torch.device(other)
    here = FastVAT().fit(X)
    np.testing.assert_array_equal(fv.order(), here.order())
    np.testing.assert_array_equal(fv.image(use_ivat=True),
                                  here.image(use_ivat=True))
    assert fv.assess().k_est == here.assess().k_est == 2

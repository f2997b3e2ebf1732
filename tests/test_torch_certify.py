"""The port's certification harness and pure-Python oracle held against the
JAX package's, on the CPU.

``repro_torch.numerics.certify`` scores a fitted ordering by its
spanning-tree weight in the f64 oracle geometry; its generators, oracle
and scores must be the reference's to the bit on the same inputs.  The
sweep itself runs here on the CPU (the plain versions of the kernels),
one generator per metric for each rung; the full 180-cell sweep runs on
the card in ``chip_smoke.py``.
"""
import numpy as np
import pytest

from repro.core import naive as jnaive
from repro.numerics import certify as jcert
from repro_torch.core import naive
from repro_torch.numerics import certify


@pytest.mark.parametrize("name", sorted(certify.GENERATORS))
def test_generators_match_reference(name):
    for seed in (0, 5):
        got = certify.GENERATORS[name](np.random.default_rng(seed), 64)
        want = jcert.GENERATORS[name](np.random.default_rng(seed), 64)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan",
                                    "cosine"])
def test_scores_match_reference(metric):
    X = certify.GENERATORS["offset_clusters"](np.random.default_rng(1), 48)
    R = certify.oracle_dissim(X, metric)
    np.testing.assert_array_equal(R, jcert.oracle_dissim(X, metric))
    oracle = naive.vat_order_naive(R.tolist())
    assert oracle == jnaive.vat_order_naive(R.tolist())
    shuffled = np.random.default_rng(2).permutation(48)
    for order in (oracle, shuffled):
        assert certify.tree_weight(R, order) == jcert.tree_weight(R, order)
        assert certify.ordering_excess(X, order, metric) == \
            jcert.ordering_excess(X, order, metric)
    assert certify.ordering_excess(X, oracle, metric) == (0.0, True)
    assert certify.ordering_excess(X, shuffled, metric)[0] > 0.0


def test_naive_vat_matches_reference():
    X = np.random.default_rng(3).normal(size=(30, 3)).tolist()
    assert naive.vat_naive(X) == jnaive.vat_naive(X)
    Rstar, _ = naive.vat_naive(X)
    assert naive.ivat_naive(Rstar) == jnaive.ivat_naive(Rstar)


def test_bounds_match_reference():
    assert (certify.EXCESS_F32, certify.EXCESS_BF16) == \
        (jcert.EXCESS_F32, jcert.EXCESS_BF16)
    assert certify.DEFAULT_METHODS == ("vat", "ivat", "flashvat", "approx")
    assert [p.mode for p in certify.DEFAULT_POLICIES] == \
        [p.mode for p in jcert.DEFAULT_POLICIES]


#: One generator per conditioned metric, a different one each.
_SMOKE = (("euclidean", "offset_clusters"), ("sqeuclidean", "near_duplicates"),
          ("manhattan", "shell"))


@pytest.mark.parametrize("method", certify.DEFAULT_METHODS)
def test_cpu_sweep_smoke_is_all_ok(method):
    results = []
    for metric, gen in _SMOKE:
        results += certify.sweep(methods=(method,), metrics=(metric,),
                                 generators={gen: certify.GENERATORS[gen]},
                                 device="cpu")
    assert len(results) == 3 * len(certify.DEFAULT_POLICIES)
    assert all(r.method == method for r in results)
    assert all(r.ok for r in results), certify.summarize(results)
    assert "0 failing" in certify.summarize(results)


def test_main_exit_code_on_the_cpu(capsys):
    assert certify.main(["--smoke", "--device", "cpu"]) == 0
    assert "0 failing" in capsys.readouterr().out


def test_cpu_full_sweep_is_all_ok():
    """The default sweep, 4 rungs x 3 metrics x 3 policies x 5 generators,
    through the plain versions."""
    results = certify.sweep(device="cpu")
    assert len(results) == 180
    assert all(r.ok for r in results), certify.summarize(results)

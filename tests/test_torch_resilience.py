"""The port's degradation ladder held against the JAX package's, on the
CPU: the counterparts of ``tests/test_resilience.py``.

* Unit: RetryPolicy gives the reference's delays, the clock-free
  CircuitBreaker the reference's transitions on the same event scripts,
  and fallback_chain the port's ladder — the reference's minus its
  Pallas -> XLA step: no level differs from its predecessor only in the
  device or the kernel route.
* Admission: the typed InvalidInput refusal at FastVAT.fit/fit_many and
  TendencyServer.submit, across rungs.
* Integration: a real threaded TendencyServer (device "cpu") on a
  VirtualClock with an injectable no-op sleep — armed faults drive the
  ladder and the tests pin EXACT ResilienceStats counter trajectories,
  including the poison-lane batch split, the build-fault fallback chain
  (flashvat to its stepwise kernel, ivat to vat), the breaker
  trip/cooldown/probe cycle, and the dispatcher-death failsafe; and the
  chaos launcher run as a command.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.serve.resilience as jres
import repro_torch.faults as faults
from _serve_clock import make_key as jmake_key
from _torch_serve_clock import VirtualClock, make_key
from repro_torch.api import FastVAT, InvalidInput
from repro_torch.serve import (BreakerConfig, CircuitBreaker, ExecutionError,
                               ResilienceStats, RetryPolicy, ServeConfig,
                               ServeError, TendencyServer, breaker_family,
                               fallback_chain)
from repro_torch.serve.resilience import CLOSED, HALF_OPEN, OPEN

CPU = "cpu"
WAIT = 60


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.disarm_all()
    yield
    faults.disarm_all()


def _blobs(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    return np.concatenate([
        rng.normal(size=(half, d)),
        rng.normal(size=(n - half, d)) + 6.0]).astype(np.float32)


def _solo(X, method, **kw):
    return FastVAT(method=method, device=CPU, **kw).fit(X).result


def _same_result(a, b) -> bool:
    for f in ("order", "rstar", "ivat_image", "sample_idx",
              "extension_labels", "group_sizes"):
        va, vb = getattr(a, f), getattr(b, f)
        if (va is None) != (vb is None):
            return False
        if va is not None and not torch.equal(va, vb):
            return False
    return True


# ====================================================== unit: retry ====

def test_retry_policy_deterministic_and_bounded():
    pol = RetryPolicy(max_attempts=3, backoff_s=0.01, backoff_cap_s=0.05,
                      jitter=0.25)
    a = [pol.delay_s(i, seed=7) for i in range(5)]
    b = [pol.delay_s(i, seed=7) for i in range(5)]
    assert a == b
    for i, delay in enumerate(a):
        base = min(0.05, 0.01 * 2 ** i)
        assert base * 0.75 <= delay <= base * 1.25
    assert pol.delay_s(0, seed=1) != pol.delay_s(0, seed=2)


@pytest.mark.parametrize("kw", [
    dict(), dict(max_attempts=3, backoff_s=0.01, backoff_cap_s=0.05),
    dict(backoff_s=0.01, backoff_cap_s=1.0, jitter=0.0),
    dict(backoff_s=0.2, backoff_cap_s=0.3, jitter=0.5)])
def test_retry_delays_match_reference(kw):
    got, want = RetryPolicy(**kw), jres.RetryPolicy(**kw)
    for seed in (0, 1, 7):
        assert [got.delay_s(i, seed=seed) for i in range(8)] == \
            [want.delay_s(i, seed=seed) for i in range(8)]


def test_retry_policy_no_jitter_exact():
    pol = RetryPolicy(backoff_s=0.01, backoff_cap_s=1.0, jitter=0.0)
    assert pol.delay_s(0) == 0.01
    assert pol.delay_s(3) == 0.08


def test_retry_policy_rejects_zero_attempts():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


# ==================================================== unit: breaker ====

def test_breaker_opens_after_threshold():
    b = CircuitBreaker(BreakerConfig(threshold=3, cooldown_s=10.0))
    assert b.state == CLOSED
    for t in range(2):
        b.record_failure(float(t))
        assert b.state == CLOSED and b.allow_primary(float(t))
    b.record_failure(2.0)
    assert b.state == OPEN and b.opens == 1
    assert not b.allow_primary(11.9)
    assert b.allow_primary(12.0)
    assert b.state == HALF_OPEN and b.probes == 1
    assert not b.allow_primary(12.0)


def test_breaker_halfopen_failure_reopens():
    b = CircuitBreaker(BreakerConfig(threshold=2, cooldown_s=5.0))
    b.record_failure(0.0)
    b.record_failure(0.0)
    assert b.state == OPEN
    assert b.allow_primary(5.0)
    b.record_failure(5.0)
    assert b.state == OPEN and b.opens == 2
    assert b.allow_primary(10.0)
    b.record_success(10.0)
    assert b.state == CLOSED and b.failures == 0


def test_breaker_success_resets_consecutive_count():
    b = CircuitBreaker(BreakerConfig(threshold=2))
    b.record_failure(0.0)
    b.record_success(0.0)
    b.record_failure(0.0)
    assert b.state == CLOSED


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("threshold,cooldown", [(1, 1.0), (2, 5.0),
                                                (3, 2.5)])
def test_breaker_transitions_match_reference(seed, threshold, cooldown):
    """A seeded script of allow/failure/success events at rising times
    drives both breakers through the same states and counters."""
    rng = np.random.default_rng(seed)
    got = CircuitBreaker(BreakerConfig(threshold=threshold,
                                       cooldown_s=cooldown))
    want = jres.CircuitBreaker(jres.BreakerConfig(threshold=threshold,
                                                  cooldown_s=cooldown))
    t = 0.0
    for _ in range(60):
        t += float(rng.choice([0.0, 0.5, 1.0, 3.0]))
        event = rng.integers(3)
        if event == 0:
            assert got.allow_primary(t) == want.allow_primary(t)
        elif event == 1:
            got.record_failure(t)
            want.record_failure(t)
        else:
            got.record_success(t)
            want.record_success(t)
        assert (got.state, got.failures, got.opened_at, got.opens,
                got.probes) == (want.state, want.failures, want.opened_at,
                                want.opens, want.probes)


# ============================================== unit: fallback chain ====

def test_fallback_chain_vat_has_no_fallback():
    key = make_key(rung="vat")
    assert fallback_chain(key) == (key,)


def test_fallback_chain_ivat_steps_down_to_vat():
    key = make_key(rung="ivat")
    chain = fallback_chain(key)
    assert [k.rung for k in chain] == ["ivat", "vat"]
    assert chain[0].n_bucket == chain[1].n_bucket


@pytest.mark.parametrize("turbo", [None, True])
def test_fallback_chain_flashvat_turbo(turbo):
    chain = fallback_chain(make_key(n=300, rung="flashvat", turbo=turbo))
    assert [k.turbo for k in chain] == [turbo, False]
    assert fallback_chain(make_key(n=300, rung="flashvat", turbo=False)) \
        == (make_key(n=300, rung="flashvat", turbo=False),)


KEYS = [make_key(rung=r, turbo=t, device=dev, **kw)
        for r in ("vat", "ivat", "flashvat")
        for t in (None, True, False)
        for dev in ("cuda", "cpu")
        for kw in (dict(), dict(num_dtype="bf16", num_form="direct"))]


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_fallback_chain_never_swaps_the_device_or_kernel_route(key):
    """Every level differs from its predecessor in the rung or the
    flashvat engine — never only in the device, the device set or a
    kernel route (the reference's Pallas -> XLA step has no counterpart),
    and every level keeps the primary's device."""
    chain = fallback_chain(key)
    assert chain[0] == key
    for prev, cur in zip(chain, chain[1:]):
        changed = {f.name for f in dataclasses.fields(key)
                   if getattr(prev, f.name) != getattr(cur, f.name)}
        assert changed and changed <= {"rung", "turbo"}
    assert all((k.device, k.mesh) == (key.device, key.mesh) for k in chain)


@pytest.mark.parametrize("rung,turbo", [("vat", None), ("ivat", None),
                                        ("flashvat", None),
                                        ("flashvat", True),
                                        ("flashvat", False)])
def test_fallback_chain_is_reference_chain_minus_pallas_step(rung, turbo):
    """The port's ladder is the reference's ladder of a use_pallas=False
    key: same rungs and turbo levels, in the same order."""
    got = fallback_chain(make_key(n=300, rung=rung, turbo=turbo))
    want = jres.fallback_chain(jmake_key(n=300, rung=rung, turbo=turbo))
    assert [(k.rung, k.turbo) for k in got] == \
        [(k.rung, k.turbo) for k in want]


def test_breaker_family_is_lane_count_agnostic():
    key = make_key(rung="ivat")
    assert breaker_family(key.with_batch(1)) == \
        breaker_family(key.with_batch(8))
    assert breaker_family(make_key(rung="vat")) != \
        breaker_family(make_key(rung="ivat"))
    assert breaker_family(make_key(device="cpu")) != \
        breaker_family(make_key(device="cuda"))


# ================================================ admission ====

@pytest.mark.parametrize("method", ["vat", "ivat", "flashvat"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_fit_rejects_non_finite_across_rungs(method, bad):
    X = _blobs(64)
    X[7, 1] = bad
    with pytest.raises(InvalidInput) as ei:
        FastVAT(method=method, device=CPU).fit(X)
    assert ei.value.reason == "non_finite"


def test_fit_validate_false_skips_admission():
    X = _blobs(32)
    X[3, 0] = np.nan
    res = FastVAT(method="vat", validate=False, device=CPU).fit(X)
    assert res.order().shape == (32,)


def test_fit_rejects_too_few_points_and_degenerate():
    with pytest.raises(InvalidInput) as ei:
        FastVAT(device=CPU).fit(np.zeros((3, 2), np.float32))
    assert ei.value.reason == "too_few_points"
    with pytest.raises(InvalidInput) as ei:
        FastVAT(device=CPU).fit(np.ones((16, 2), np.float32))
    assert ei.value.reason == "degenerate"


def test_fit_rejects_bad_dtype():
    with pytest.raises(InvalidInput) as ei:
        FastVAT(device=CPU).fit(np.array([["a", "b"]] * 8))
    assert ei.value.reason == "dtype"


def test_fit_precomputed_rejects_non_finite():
    X = _blobs(16)
    D = np.linalg.norm(X[:, None] - X[None, :], axis=-1)
    D[3, 5] = D[5, 3] = np.nan
    with pytest.raises(InvalidInput) as ei:
        FastVAT(metric="precomputed", device=CPU).fit(D.astype(np.float32))
    assert ei.value.reason == "non_finite"


def test_fit_many_names_poison_lane():
    Xs = np.stack([_blobs(32), _blobs(32, seed=1)])
    Xs[1, 5, 0] = np.inf
    with pytest.raises(InvalidInput, match=r"lane\(s\) \[1\]"):
        FastVAT(method="vat", device=CPU).fit_many(Xs)


# ========================================== server chaos integration ====

def _chaos_server(**cfg):
    cfg.setdefault("window_s", 999.0)
    cfg.setdefault("retry", RetryPolicy(max_attempts=2, jitter=0.0))
    clock = VirtualClock()
    srv = TendencyServer(ServeConfig(device=CPU, **cfg), clock=clock,
                         sleep=lambda s: None)
    return srv, clock


def test_submit_admission_rejects_and_counts():
    srv, _ = _chaos_server(max_batch=1)
    try:
        X = _blobs(32)
        X[0, 0] = np.nan
        with pytest.raises(InvalidInput):
            srv.submit(X)
        with pytest.raises(InvalidInput):
            srv.submit(np.ones((16, 3), np.float32))
        assert srv.stats().resilience == ResilienceStats(invalid_rejects=2)
    finally:
        srv.close()


def test_poison_lane_fails_alone_batchmates_bitwise_correct():
    """One poisoned lane of a 4-lane coalesced batch fails typed; the
    other three get results bitwise-equal to solo fits."""
    srv, _ = _chaos_server(max_batch=4)
    try:
        faults.arm("serve.execute", times=-1,
                   match=lambda ctx: "poison" in ctx.get("tags", ()))
        Xs = {tag: _blobs(48, seed=i)
              for i, tag in enumerate(["a", "b", "poison", "c"])}
        futs = {tag: srv.submit(X, method="vat", tag=tag)
                for tag, X in Xs.items()}
        for tag in ("a", "b", "c"):
            served = futs[tag].result(timeout=WAIT)
            assert _same_result(served, _solo(Xs[tag], "vat"))
        with pytest.raises(ExecutionError) as ei:
            futs["poison"].result(timeout=WAIT)
        assert isinstance(ei.value.__cause__, faults.FaultInjected)
        assert ei.value.__cause__.site == "serve.execute"
        assert srv.stats().resilience == ResilienceStats(
            splits=1, retries=2, failed=1)
    finally:
        srv.close()


def test_build_fault_served_via_fallback_chain():
    """A primary whose program BUILD fails is served by the next chain
    level — an error turned into a (coarser) result."""
    srv, _ = _chaos_server(max_batch=1)
    try:
        faults.arm("serve.build", times=-1,
                   match=lambda ctx: ctx.get("rung") == "ivat")
        X = _blobs(48)
        served = srv.submit(X, method="ivat").result(timeout=WAIT)
        assert served.meta.method == "vat"
        assert _same_result(served, _solo(X, "vat"))
        assert srv.stats().resilience == ResilienceStats(
            fallbacks=1, retries=1, degraded=1)
    finally:
        srv.close()


def test_flashvat_build_fault_served_by_stepwise_engine():
    """A flashvat primary whose persistent-kernel program fails to build
    is served by the stepwise kernel's program: the same bits as the solo
    stepwise and persistent fits, one counted fallback."""
    srv, _ = _chaos_server(max_batch=1)
    try:
        faults.arm("serve.build", times=-1,
                   match=lambda ctx: ctx["key"].turbo is not False)
        X = _blobs(48)
        served = srv.submit(X, method="flashvat").result(timeout=WAIT)
        assert served.meta.method == "flashvat"
        assert _same_result(served, _solo(X, "flashvat", turbo=False))
        assert _same_result(served, _solo(X, "flashvat"))
        assert srv.stats().resilience == ResilienceStats(
            fallbacks=1, retries=1, degraded=1)
        assert faults.stats()["serve.build"]["fired"] == 2
    finally:
        srv.close()


def test_breaker_trips_pins_fallback_and_reprobes():
    srv, clock = _chaos_server(
        max_batch=1, retry=RetryPolicy(max_attempts=1),
        breaker=BreakerConfig(threshold=2, cooldown_s=10.0))
    try:
        faults.arm("serve.build", times=-1,
                   match=lambda ctx: ctx.get("rung") == "ivat")
        X = _blobs(48)

        def ivat_fit():
            return srv.submit(X, method="ivat").result(timeout=WAIT)

        ivat_fit()
        assert srv.breaker_state(48, 3, method="ivat") == CLOSED
        ivat_fit()
        assert srv.breaker_state(48, 3, method="ivat") == OPEN

        built_before = faults.stats()["serve.build"]["fired"]
        served = ivat_fit()
        assert served.meta.method == "vat"
        assert faults.stats()["serve.build"]["fired"] == built_before

        stats = srv.stats().resilience
        assert stats.breaker_opens == 1
        assert stats.breaker_probes == 0
        assert stats.degraded == 3
        assert stats.fallbacks == 3
        assert stats.breakers and stats.breakers[0][1] == OPEN
        assert stats.open_breakers == 1

        clock.advance(10.0)
        ivat_fit()
        stats = srv.stats().resilience
        assert stats.breaker_probes == 1
        assert stats.breaker_opens == 2
        assert srv.breaker_state(48, 3, method="ivat") == OPEN

        faults.disarm("serve.build")
        clock.advance(10.0)
        served = ivat_fit()
        assert served.meta.method == "ivat"
        assert _same_result(served, _solo(X, "ivat"))
        assert srv.breaker_state(48, 3, method="ivat") == CLOSED
        stats = srv.stats().resilience
        assert stats.breaker_probes == 2
        assert stats.breakers == ()
    finally:
        srv.close()


def test_transient_fault_absorbed_by_retry():
    srv, _ = _chaos_server(max_batch=1)
    try:
        faults.arm("serve.execute", times=1)
        X = _blobs(48)
        served = srv.submit(X, method="vat").result(timeout=WAIT)
        assert _same_result(served, _solo(X, "vat"))
        stats = srv.stats().resilience
        assert stats.retries == 1
        assert stats.failed == 0 and stats.fallbacks == 0
    finally:
        srv.close()


def test_delay_fault_runs_on_injected_sleep():
    slept = []
    clock = VirtualClock()
    srv = TendencyServer(ServeConfig(window_s=999.0, max_batch=1,
                                     device=CPU),
                         clock=clock, sleep=slept.append)
    try:
        faults.arm("serve.execute", kind="delay", delay_s=2.5)
        srv.submit(_blobs(48), method="vat").result(timeout=WAIT)
        assert 2.5 in slept
    finally:
        srv.close()


class _Die(BaseException):
    """Not an Exception: sails past the ladder's handlers, killing the
    dispatcher thread — the failsafe under test."""


def test_dispatcher_death_fails_all_futures_typed():
    srv, _ = _chaos_server(max_batch=2)
    try:
        faults.arm("serve.execute", exc=_Die, times=1)
        q = srv.submit(_blobs(100), method="vat", tag="queued")
        f1 = srv.submit(_blobs(48), method="vat", tag="x")
        f2 = srv.submit(_blobs(48, seed=1), method="vat", tag="y")
        for fut in (f1, f2, q):
            with pytest.raises(ServeError, match="dispatcher thread died"):
                fut.result(timeout=WAIT)
        with pytest.raises(ServeError, match="closed"):
            srv.submit(_blobs(48))
    finally:
        srv.close()


def test_close_dispatches_queued_requests():
    srv, _ = _chaos_server(max_batch=8)
    X = _blobs(48)
    try:
        fut = srv.submit(X, method="vat")
        assert not fut.done()
    finally:
        srv.close()
    assert _same_result(fut.result(timeout=WAIT), _solo(X, "vat"))


def test_disarmed_server_stats_all_zero():
    srv, _ = _chaos_server(max_batch=1)
    try:
        X = _blobs(48)
        for method in ("vat", "ivat", "flashvat"):
            served = srv.submit(X, method=method).result(timeout=WAIT)
            assert _same_result(served, _solo(X, method))
        assert srv.stats().resilience == ResilienceStats()
    finally:
        srv.close()


def test_chaos_launcher_smoke_on_cpu():
    """``python -m repro_torch.launch.chaos --smoke --device cpu``: every
    scenario's exact counter pins hold, exit 0."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.chaos",
                          "--smoke", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "chaos: 6/6 scenarios clean" in out.stdout
    for name in ("poison", "fallback", "breaker", "admission",
                 "numerics_trip", "disarmed"):
        assert f"chaos/{name}" in out.stdout

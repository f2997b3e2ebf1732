"""The port's serving layer held against the JAX package's and against its
own solo fits, on the CPU.

The counterparts of ``tests/test_serve.py`` (all but the example and the
bench tables, which need ``examples/`` and ``benchmarks/``), on the port's
rig ``tests/_torch_serve_clock.py``:

* **Deterministic concurrency** — the virtual-clock rig drives the port's
  clock-free ``CoalescerCore``; the same schedules through the
  reference's rig give the same batches, expiries and counters.
* **Program-cache census** — a warm-cache request builds ZERO new
  programs, every knob that shapes a program is key material (``device``
  in place of ``use_pallas``), LRU eviction at the bound; ``resolve_key``
  gives the reference's key material and routing under the reference's
  latency coefficients.
* **Bitwise fidelity** — served results equal solo ``FastVAT(device=
  "cpu").fit`` bit for bit across rungs and metrics, for coalesced
  batches, under real-thread mixed-shape load, and at bucket boundaries
  +-1 for every metric; on integer data they equal the reference's
  served vat/ivat results.
* **Routing + lifecycle** — the card-fitted SLO router, rejections,
  ``warm()``, ``close()`` drain, and the device contract (the default
  "cuda" raises without a GPU).

Every wait on a future carries a timeout and every server is closed.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _serve_clock as jrig
from _torch_serve_clock import CoalesceRig, VirtualClock, make_key
from repro.api import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.serve import TendencyServer as JTendencyServer
from repro.serve import resolve_key as jresolve_key
from repro_torch.api import FastVAT, registry
from repro_torch.api.registry import (predict_latency_us,
                                      select_method_for_slo)
from repro_torch.serve import (Backpressure, DeadlineExceeded, ProgramCache,
                               ServeConfig, ServeError, TendencyServer,
                               bucket_n, mesh_fingerprint, pad_rows,
                               real_positions, resolve_key, restrict,
                               trace_census)

CPU = "cpu"
WAIT = 60          # seconds any test waits on a future
FIELDS = ("order", "rstar", "ivat_image", "sample_idx", "extension_labels",
          "group_sizes")


def _blobs(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    return np.concatenate([
        rng.normal(size=(half, d)),
        rng.normal(size=(n - half, d)) + 6.0]).astype(np.float32)


def _int_blobs(n, d=3, seed=0):
    """Two clusters on integer coordinates: every entry is an exact f32
    integer (or its square root) in both frameworks, ties included."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0] * d, [9] * d])
    return (centers[np.arange(n) % 2]
            + rng.integers(-3, 4, size=(n, d))).astype(np.float32)


def _solo(X, method, metric="euclidean", **kw):
    return FastVAT(method=method, metric=metric, device=CPU,
                   **kw).fit(X).result


def _same_result(a, b) -> bool:
    """Bitwise equality of two port TendencyResults' tensor fields."""
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if (va is None) != (vb is None):
            return False
        if va is not None and not torch.equal(va, vb):
            return False
    return True


def _server(**cfg):
    return TendencyServer(ServeConfig(device=CPU, **cfg))


# ================================================ virtual-clock rig ====
# Pure scheduling logic: no kernels, no threads, no sleeps.

def test_window_coalesces_same_bucket():
    rig = CoalesceRig(window=1.0)
    rig.submit("a", 0.0)
    rig.submit("b", 0.5)                      # same bucket, inside window
    assert rig.batch_tags() == []             # window still open
    rig.run_until(1.0)                        # flush at opened + window
    assert rig.batch_tags() == [["a", "b"]]
    assert rig.dispatches[0][0] == 1.0


def test_distinct_buckets_never_share_a_batch():
    rig = CoalesceRig(window=1.0)
    rig.submit("small", 0.0, n=100)           # bucket 128
    rig.submit("large", 0.1, n=200)           # bucket 256
    rig.run_until(2.0)
    assert rig.batch_tags() == [["small"], ["large"]]
    assert rig.dispatches[0][1].n_bucket == 128
    assert rig.dispatches[1][1].n_bucket == 256


def test_max_batch_flushes_immediately():
    rig = CoalesceRig(window=1.0, max_batch=2)
    rig.submit("a", 0.0)
    rig.submit("b", 0.1)                      # hits max_batch: no waiting
    assert rig.batch_tags() == [["a", "b"]]
    assert rig.dispatches[0][0] == 0.1
    rig.submit("c", 0.2)                      # opens a NEW window
    rig.run_until(1.2)
    assert rig.batch_tags() == [["a", "b"], ["c"]]


def test_deadline_expires_queued_request():
    rig = CoalesceRig(window=1.0)
    rig.submit("doomed", 0.0, timeout_s=0.4)
    rig.run_until(2.0)
    assert rig.expired == [(0.4, "doomed")]
    assert rig.batch_tags() == []


def test_deadline_expires_one_lane_batch_survives():
    rig = CoalesceRig(window=1.0)
    rig.submit("doomed", 0.0, timeout_s=0.4)
    rig.submit("alive", 0.0, timeout_s=10.0)
    rig.run_until(1.0)
    assert rig.expired == [(0.4, "doomed")]
    assert rig.batch_tags() == [["alive"]]


def test_deadline_equal_to_flush_rides_the_batch():
    rig = CoalesceRig(window=1.0)
    rig.submit("edge", 0.0, timeout_s=1.0)
    rig.run_until(1.0)
    assert rig.expired == []
    assert rig.batch_tags() == [["edge"]]


def test_backpressure_bounds_the_queue():
    rig = CoalesceRig(window=10.0, max_pending=2)
    rig.submit("a", 0.0)
    rig.submit("b", 0.1, n=200)
    with pytest.raises(Backpressure):
        rig.submit("c", 0.2)
    assert rig.core.rejected == 1
    assert rig.core.pending == 2


def test_due_flush_at_full_queue_submit_is_never_lost():
    rig = CoalesceRig(window=1.0, max_pending=2)
    rig.submit("a", 0.0)
    rig.submit("b", 0.5, n=200)
    rig.submit("c", 1.0)                      # a's flush due exactly now
    assert rig.batch_tags() == [["a"]]
    assert rig.core.pending == 2
    assert rig.core.rejected == 0


def test_due_expiry_at_full_queue_submit_is_never_lost():
    rig = CoalesceRig(window=10.0, max_pending=2)
    rig.submit("a", 0.0, timeout_s=0.4)
    rig.submit("b", 0.1, n=200)
    rig.submit("c", 0.5)                      # a's deadline due at 0.4
    assert rig.expired == [(0.4, "a")]
    assert rig.core.pending == 2 and rig.core.rejected == 0


def test_rejection_has_no_side_effects_on_the_queue():
    rig = CoalesceRig(window=10.0, max_pending=2)
    rig.submit("a", 0.0)
    rig.submit("b", 0.1, n=200)
    before = (rig.core.pending, rig.core.submitted, rig.core.next_event())
    with pytest.raises(Backpressure):
        rig.submit("c", 0.2)
    assert (rig.core.pending, rig.core.submitted,
            rig.core.next_event()) == before
    assert rig.core.rejected == 1
    rig.run_until(10.1)
    assert rig.batch_tags() == [["a"], ["b"]]


def test_late_arrival_opens_a_fresh_window():
    rig = CoalesceRig(window=1.0)
    rig.submit("a", 0.0)
    rig.run_until(3.0)
    rig.submit("b", 5.0)
    rig.run_until(5.5)
    assert rig.batch_tags() == [["a"]]
    rig.run_until(6.0)
    assert rig.batch_tags() == [["a"], ["b"]]


def test_drain_flushes_open_windows_but_honors_deadlines():
    rig = CoalesceRig(window=100.0)
    rig.submit("late", 0.0, timeout_s=0.5)
    rig.submit("fine", 0.0, timeout_s=50.0)
    rig.drain(1.0)
    assert rig.expired == [(0.5, "late")]
    assert rig.batch_tags() == [["fine"]]


def test_scheduler_counters():
    rig = CoalesceRig(window=1.0, max_batch=8)
    for i, t in enumerate([0.0, 0.2, 0.4]):
        rig.submit(i, t)
    rig.run_until(1.0)
    c = rig.core
    assert (c.submitted, c.dispatched_batches, c.dispatched_requests,
            c.timeouts, c.rejected, c.pending) == (3, 1, 3, 0, 0, 0)


def test_virtual_clock_is_monotonic():
    clk = VirtualClock(5.0)
    assert clk() == 5.0
    clk.advance(1.5)
    assert clk() == 6.5
    with pytest.raises(ValueError):
        clk.set(2.0)
    with pytest.raises(ValueError):
        clk.advance(-1.0)


def _random_schedule(seed, steps=40):
    """A seeded script of submits (mixed buckets and deadlines), clock
    advances and a final drain, as the rig's calls."""
    rng = np.random.default_rng(seed)
    t, ops = 0.0, []
    for i in range(steps):
        t += float(rng.choice([0.0, 0.1, 0.25, 0.5, 1.0]))
        if rng.random() < 0.75:
            ops.append(("submit", i, t,
                        dict(n=int(rng.choice([50, 100, 200])),
                             timeout_s=float(rng.choice([0.3, 1.0, 10.0])))))
        else:
            ops.append(("run", t))
    ops.append(("drain", t + 0.5))
    return ops


def _replay(rig, ops, bp_error):
    rejected = []
    for op in ops:
        if op[0] == "submit":
            try:
                rig.submit(op[1], op[2], **op[3])
            except bp_error:
                rejected.append(op[1])
        elif op[0] == "run":
            rig.run_until(op[1])
        else:
            rig.drain(op[1])
    c = rig.core
    return ([(t, k.n_bucket, tags) for t, k, tags in rig.dispatches],
            rig.expired, rejected,
            (c.submitted, c.dispatched_batches, c.dispatched_requests,
             c.timeouts, c.rejected, c.pending))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("window,max_batch,max_pending",
                         [(1.0, 8, 256), (0.3, 3, 256), (0.5, 4, 5)])
def test_rig_schedule_matches_reference(seed, window, max_batch,
                                        max_pending):
    """The same virtual-clock schedule through the reference's rig and the
    port's gives the same batches (time, bucket, members), expiries,
    rejections and counters."""
    from repro.serve import Backpressure as JBackpressure
    ops = _random_schedule(seed)
    cfg = dict(window=window, max_batch=max_batch, max_pending=max_pending)
    got = _replay(CoalesceRig(**cfg), ops, Backpressure)
    want = _replay(jrig.CoalesceRig(**cfg), ops, JBackpressure)
    assert got == want
    assert got[0]                              # the schedule dispatched


# ============================================== program-cache census ===

def test_every_code_shaping_knob_is_key_material():
    """Any knob that changes a program must change the ProgramKey; the
    device takes the place of the reference's use_pallas."""
    base = dict(n=100, d=4)
    variants = [
        make_key(**base),
        make_key(**base, rung="ivat"),
        make_key(n=100, d=4, rung="flashvat"),
        make_key(**base, metric="cosine"),
        make_key(**base, metric="manhattan"),
        make_key(n=300, d=4),                     # different n-bucket
        make_key(n=100, d=8),                     # d is never padded
        make_key(**base, mesh="cuda:8"),          # device-set fingerprint
        make_key(**base, turbo=True),
        make_key(**base, turbo=False),
        make_key(**base, device="cpu"),
        make_key(**base, sample_size=128),
        make_key(**base, num_form="direct"),
        make_key(**base, num_dtype="bf16"),
        make_key(**base).with_batch(2),
        make_key(**base).with_batch(4),
    ]
    assert len(set(variants)) == len(variants)
    fields = {f.name for f in dataclasses.fields(variants[0])}
    assert "use_pallas" not in fields and "device" in fields


def test_mesh_fingerprint_names_the_torch_device_set():
    assert mesh_fingerprint("cpu") == "cpu:1"
    assert mesh_fingerprint("cuda") == f"cuda:{torch.cuda.device_count()}"
    key = resolve_key(100, 4, config=ServeConfig(device=CPU))
    assert (key.mesh, key.device) == ("cpu:1", CPU)


def test_flashvat_keys_on_exact_n_padded_rungs_on_bucket():
    cfg = ServeConfig(device=CPU)
    kv = resolve_key(100, 4, method="vat", config=cfg, mesh="test:1")
    kf = resolve_key(100, 4, method="flashvat", config=cfg, mesh="test:1")
    assert kv.n_bucket == bucket_n(100) == 128
    assert kf.n_bucket == 100
    kf2 = resolve_key(101, 4, method="flashvat", config=cfg, mesh="test:1")
    assert kf != kf2


def test_lru_eviction_at_capacity():
    cache = ProgramCache(capacity=2)
    k1, k2, k3 = (make_key(n, 4).with_batch(1) for n in (10, 100, 200))
    built = []
    for k in (k1, k2, k3):
        cache.get(k, lambda k=k: built.append(k) or object())
    assert built == [k1, k2, k3]
    assert k1 not in cache and k2 in cache and k3 in cache
    s = cache.stats()
    assert (s.hits, s.misses, s.evictions, s.size) == (0, 3, 1, 2)
    cache.get(k2, lambda: pytest.fail("k2 must be a hit"))
    assert cache.stats().hits == 1


def test_lru_hit_refreshes_recency():
    cache = ProgramCache(capacity=2)
    k1, k2, k3 = (make_key(n, 4).with_batch(1) for n in (10, 100, 200))
    cache.get(k1, object)
    cache.get(k2, object)
    cache.get(k1, object)
    cache.get(k3, object)
    assert k1 in cache and k2 not in cache and k3 in cache


def test_warm_cache_builds_zero_new_programs():
    """The census pin: the second request in a bucket builds nothing."""
    with _server(window_s=0.001) as srv:
        srv.submit(_blobs(50)).result(timeout=WAIT)   # cold: bucket-64
        t0, s0 = trace_census()["traces"], srv.stats().cache
        res = srv.submit(_blobs(60, seed=1)).result(timeout=WAIT)
        t1, s1 = trace_census()["traces"], srv.stats().cache
    assert t1 - t0 == 0
    assert s1.misses - s0.misses == 0
    assert s1.hits - s0.hits == 1
    assert _same_result(res, _solo(_blobs(60, seed=1), "vat"))


def test_warm_precompiles_the_request_path():
    with _server(window_s=0.001) as srv:
        key = srv.warm(50, 3, batch=1)
        assert key.b_bucket == 1 and key.n_bucket == 64
        t0, m0 = trace_census()["traces"], srv.stats().cache.misses
        srv.submit(_blobs(50)).result(timeout=WAIT)
        assert trace_census()["traces"] - t0 == 0
        assert srv.stats().cache.misses - m0 == 0


def test_warm_with_slo_precompiles_the_slo_routed_key():
    """warm() with the requests' slo_ms targets the router's key (ivat
    here, not the size policy's vat), so the fits are pure cache hits."""
    with _server(window_s=0.001) as srv:
        key = srv.warm(60, 3, slo_ms=50.0, batch=1)
        assert key.rung == "ivat"
        t0, m0 = trace_census()["traces"], srv.stats().cache.misses
        res = srv.submit(_blobs(60), slo_ms=50.0).result(timeout=WAIT)
        assert trace_census()["traces"] - t0 == 0
        assert srv.stats().cache.misses - m0 == 0
    assert res.meta.method == "ivat"


def test_program_build_runs_no_fit(monkeypatch):
    """A program's build binds the rung's batched fitter to the key and runs
    nothing (eager PyTorch compiles no shape): the fitter runs once a
    dispatch, and the build counts one in the census."""
    from repro_torch.serve.server import _build_program
    calls = []
    rung = registry.get_rung("vat")
    monkeypatch.setitem(registry._REGISTRY, "vat", dataclasses.replace(
        rung, fit_batch=lambda Xs, meta, opts: calls.append(
            (tuple(Xs.shape), meta.n, meta.batch, opts.turbo)) or "fit"))
    key = make_key(50, 3).with_batch(2)
    t0 = trace_census()["traces"]
    program = _build_program(key, seed=0)
    assert calls == [] and trace_census()["traces"] - t0 == 1
    assert program(torch.zeros(2, 64, 3)) == "fit"
    assert calls == [((2, 64, 3), 64, 2, None)]


@pytest.mark.parametrize("method", ["vat", "ivat", "flashvat"])
def test_primary_key_runs_the_rungs_default_engine(method):
    """No server knob pins the engine: every primary key carries
    ``turbo=None`` (flashvat's persistent kernel), and only the ladder's
    level below a flashvat primary carries ``turbo=False``."""
    from repro_torch.serve import fallback_chain
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    assert not fields & {"turbo", "knn_k", "use_pallas"}
    key = resolve_key(100, 4, method=method,
                      config=ServeConfig(device=CPU), mesh="test:1")
    assert key.turbo is None
    assert [k.turbo for k in fallback_chain(key)] == \
        {"vat": [None], "ivat": [None, None], "flashvat": [None, False]}[method]


# ======================================= key parity with the reference ===

@pytest.fixture
def reference_latency_models(monkeypatch):
    """Each port rung's latency model replaced by the reference's, so the
    router reads the reference's coefficients."""
    for name in registry.registered():
        rung = registry.get_rung(name)
        want = jregistry.get_rung(name).latency_model
        monkeypatch.setitem(registry._REGISTRY, name, dataclasses.replace(
            rung, latency_model=(None if want is None else
                                 registry.LatencyModel(
                                     **dataclasses.asdict(want)))))


#: The reference's key fields the port keeps (its ``knn_k`` is left out:
#: no servable rung reads it).
KEY_FIELDS = ("rung", "b_bucket", "n_bucket", "d", "metric", "mesh",
              "turbo", "sample_size", "num_form", "num_dtype")


def _resolved(resolve, config, **kw):
    try:
        key = resolve(mesh="test:1", config=config, **kw)
    except (ValueError, LookupError) as exc:
        return type(exc).__name__
    return tuple(getattr(key, f) for f in KEY_FIELDS)


@pytest.mark.parametrize("n", [4, 63, 64, 65, 1024, 2048, 2049, 30_000,
                               50_000, 60_000])
def test_resolve_key_matches_reference(reference_latency_models, n):
    """resolve_key gives the reference's key material and routing for every
    method, metric, SLO and numerics plan, under the reference's
    coefficients (errors by type)."""
    for method in ("auto", "vat", "ivat", "flashvat", "bigvat"):
        for metric in ("euclidean", "cosine", "precomputed"):
            for slo_ms in (None, 1.0, 20.0, 50.0, 1e5):
                for form, dtype in (("gram", "f32"), ("direct", "bf16")):
                    kw = dict(method=method, metric=metric, slo_ms=slo_ms,
                              num_form=form, num_dtype=dtype)
                    got = _resolved(resolve_key, ServeConfig(device=CPU),
                                    n=n, d=4, **kw)
                    want = _resolved(jresolve_key, JServeConfig(),
                                     n=n, d=4, **kw)
                    assert got == want, (n, kw)


def test_slo_router_matches_reference_coefficients(
        reference_latency_models):
    """The reference's routing pins, through the port's router."""
    servable = ("vat", "ivat", "flashvat")
    assert select_method_for_slo(1024, 50e3, restrict=servable) == "ivat"
    assert select_method_for_slo(1024, 20e3, restrict=servable) == "vat"
    assert select_method_for_slo(1024, 1e3, restrict=servable) == "vat"
    assert select_method_for_slo(30_000, 60e6, restrict=servable) \
        == "flashvat"
    with pytest.raises(LookupError):
        select_method_for_slo(100, 1e3, restrict=("dvat",))
    assert predict_latency_us("flashvat", 500) \
        > predict_latency_us("ivat", 500)
    assert select_method_for_slo(500, 40e3, restrict=servable) == "ivat"
    assert select_method_for_slo(200, 1e6) == "ivat"
    for name in ("vat", "ivat", "flashvat", "svat", "bigvat", "approx"):
        for n in (100, 2048, 50_000):
            assert predict_latency_us(name, n) == \
                jregistry.predict_latency_us(name, n)


# ============================================== routing (card fit) =====

#: The fit walls the latency models were fitted to: (rung, n, lanes,
#: seconds) on one H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md §5,
#: §6).
CARD_WALLS = [("vat", 2048, 1, 0.0127), ("vat", 2048, 8, 0.0342),
              ("ivat", 2048, 1, 0.0115), ("ivat", 16_384, 1, 0.109),
              ("flashvat", 2048, 1, 0.0119),
              ("flashvat", 50_000, 1, 0.310), ("flashvat", 50_000, 4, 1.30),
              ("approx", 1_000_000, 1, 5.13),
              ("bigvat", 1_000_000, 1, 0.337), ("svat", 50_000, 1, 0.0943)]


@pytest.mark.parametrize("rung,n,b,wall_s", CARD_WALLS)
def test_latency_model_reproduces_the_card_walls(rung, n, b, wall_s):
    """Each model gives back the card walls it was fitted to within 5 %."""
    got = predict_latency_us(rung, n, batch=b) / 1e6
    assert abs(got - wall_s) <= 0.05 * wall_s


def test_slo_router_on_card_coefficients():
    """At n = 2,048 ivat fits 20 ms and is the cheapest when nothing fits
    5 ms; at 16,384 only flashvat fits 80 ms and ivat 200 ms; past the
    materialized cap only flashvat is offered."""
    servable = ("vat", "ivat", "flashvat")
    for slo_ms in (5, 20, 100, 1000):
        assert select_method_for_slo(2048, slo_ms * 1e3,
                                     restrict=servable) == "ivat"
    assert select_method_for_slo(16_384, 80e3,
                                 restrict=servable) == "flashvat"
    assert select_method_for_slo(16_384, 200e3,
                                 restrict=servable) == "ivat"
    for slo_ms in (5, 20, 100, 1000):
        assert select_method_for_slo(50_000, slo_ms * 1e3,
                                     restrict=servable) == "flashvat"
    assert select_method_for_slo(200, 1e6) == "ivat"
    with pytest.raises(LookupError):
        select_method_for_slo(100, 1e3, restrict=("dvat",))


def test_latency_model_predictions_are_monotonic():
    assert predict_latency_us("dvat", 100) is None
    for method in ("vat", "ivat", "flashvat", "approx", "bigvat", "svat"):
        lo, hi = (predict_latency_us(method, n) for n in (100, 10_000))
        assert lo is not None and hi > lo
    one = predict_latency_us("vat", 512)
    four = predict_latency_us("vat", 512, batch=4)
    assert one < four < 4 * one


def test_fidelity_ranks_are_the_reference_ranks():
    for name in registry.registered():
        assert registry.get_rung(name).fidelity == \
            jregistry.get_rung(name).fidelity
    assert registry._MATERIALIZE_CAP_N == jregistry._MATERIALIZE_CAP_N
    for name in ("vat", "ivat"):
        assert registry.get_rung(name).latency_model.cap_n == 20_000


def test_resolve_key_slo_routes_through_cost_model():
    cfg = ServeConfig(device=CPU)
    k = resolve_key(2048, 4, config=cfg, slo_ms=20.0, mesh="test:1")
    assert k.rung == "ivat"
    k = resolve_key(16_384, 4, config=cfg, slo_ms=80.0, mesh="test:1")
    assert k.rung == "flashvat" and k.n_bucket == 16_384


def test_precomputed_metric_is_rejected():
    with pytest.raises(ValueError, match="precomputed"):
        resolve_key(100, 100, metric="precomputed",
                    config=ServeConfig(device=CPU), mesh="test:1")


def test_oversize_request_gets_actionable_error():
    with pytest.raises(ValueError, match="servable"):
        resolve_key(60_000, 4, config=ServeConfig(device=CPU),
                    mesh="test:1")


def test_unservable_method_is_rejected():
    with pytest.raises(ValueError, match="serving layer"):
        resolve_key(100, 4, method="bigvat", config=ServeConfig(device=CPU),
                    mesh="test:1")


# ============================================== bitwise fidelity =======

@pytest.fixture(scope="module")
def server():
    with _server(window_s=0.001) as srv:
        yield srv


@pytest.mark.parametrize("method,metric", [
    ("vat", "euclidean"), ("vat", "sqeuclidean"),
    ("vat", "manhattan"), ("vat", "cosine"),
    ("ivat", "euclidean"), ("ivat", "cosine"),
    ("flashvat", "euclidean"), ("flashvat", "manhattan"),
    ("flashvat", "cosine"), ("flashvat", "sqeuclidean"),
])
def test_served_equals_solo_bitwise(server, method, metric):
    X = _blobs(60)
    served = server.submit(X, method=method, metric=metric).result(
        timeout=WAIT)
    assert served.meta.method == method
    assert served.meta.device == "cpu" and served.order.device.type == "cpu"
    assert _same_result(served, _solo(X, method, metric))


@pytest.mark.parametrize("method", ["vat", "ivat"])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan",
                                    "cosine"])
@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129, 255, 256, 257])
def test_served_at_bucket_boundaries_equals_solo(server, n, metric, method):
    """Served (padded to the bucket, then restricted) == the solo fit, bit
    for bit, at bucket boundaries +-1 for every metric."""
    X = _blobs(n, seed=n)
    served = server.submit(X, method=method, metric=metric).result(
        timeout=WAIT)
    assert _same_result(served, _solo(X, method, metric))


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan",
                                    "cosine"])
@pytest.mark.parametrize("n", [63, 65, 129, 257])
def test_padding_never_perturbs_the_ordering(n, metric):
    """Dup-row-0 padding, then extraction (host and tensor helpers),
    reproduces the unpadded fit bitwise."""
    X = _blobs(n, seed=n + 1)
    solo = _solo(X, "vat", metric)
    padded = _solo(pad_rows(X, bucket_n(n)), "vat", metric)
    pos = real_positions(padded.order, n)
    assert torch.equal(padded.order[pos], solo.order)
    assert torch.equal(restrict(padded.rstar, pos), solo.rstar)
    host = real_positions(padded.order.numpy(), n)
    np.testing.assert_array_equal(host, pos.numpy())
    np.testing.assert_array_equal(restrict(padded.rstar.numpy(), host),
                                  solo.rstar.numpy())


def test_padding_preserves_the_ivat_image():
    n = 65
    X = _blobs(n, seed=2)
    solo = _solo(X, "ivat")
    padded = _solo(pad_rows(X, bucket_n(n)), "ivat")
    pos = real_positions(padded.order, n)
    assert torch.equal(restrict(padded.ivat_image, pos), solo.ivat_image)


def test_repeated_rows_served_equal_solo(server):
    """Real duplicate rows (frontier-0 ties, zero-weight Prim edges) beside
    the padding rows: order, R* and the iVAT image still equal solo."""
    X = _blobs(100, seed=5)
    X[60:90] = X[3]
    X[40:45] = X[0]
    for method in ("vat", "ivat"):
        served = server.submit(X, method=method).result(timeout=WAIT)
        assert _same_result(served, _solo(X, method))


def test_coalesced_batch_members_equal_solo_bitwise():
    """Four requests in one window -> ONE batched dispatch, every lane
    bitwise-identical to its solo fit."""
    Xs = [_blobs(40 + 7 * i, seed=i) for i in range(4)]
    with _server(window_s=0.25, max_batch=8) as srv:
        srv.warm(64, 3, method="vat", batch=4)
        futures = [srv.submit(X, method="vat") for X in Xs]
        results = [f.result(timeout=WAIT) for f in futures]
        st = srv.stats()
    assert st.dispatched_batches == 1
    assert st.dispatched_requests == 4
    assert st.coalesce_rate == 4.0
    for X, res in zip(Xs, results):
        assert _same_result(res, _solo(X, "vat"))


def test_coalesced_flashvat_lanes_equal_solo_bitwise():
    """Two same-n flashvat requests ride one batched dispatch; each lane
    (order, band image, representatives, labels, band sizes) equals its
    solo fit — which the reference's served flashvat does not."""
    Xs = [_blobs(80, seed=s) for s in (11, 12)]
    with _server(window_s=5.0, max_batch=2) as srv:
        futures = [srv.submit(X, method="flashvat") for X in Xs]
        results = [f.result(timeout=WAIT) for f in futures]
        assert srv.stats().dispatched_batches == 1
    for X, res in zip(Xs, results):
        assert _same_result(res, _solo(X, "flashvat"))


def test_mixed_concurrent_stress_is_bitwise_exact():
    """Real threads, mixed shapes/metrics/rungs submitted concurrently;
    every result must equal its solo fit bit for bit."""
    cases = []
    for i in range(14):
        n = (40, 50, 60, 64)[i % 4]
        method = ("vat", "ivat")[i % 2]
        metric = ("euclidean", "cosine")[(i // 2) % 2]
        cases.append((_blobs(n, seed=i), method, metric))
    cases += [(_blobs(80, seed=99), "flashvat", "euclidean"),
              (_blobs(80, seed=98), "flashvat", "euclidean")]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _server(window_s=0.02, max_batch=4) as srv:
            with ThreadPoolExecutor(max_workers=8) as pool:
                futs = [pool.submit(
                    lambda X, m, mt: srv.submit(X, method=m, metric=mt)
                    .result(timeout=WAIT), X, m, mt) for X, m, mt in cases]
                results = [f.result(timeout=WAIT) for f in futs]
            st = srv.stats()
    finally:
        sys.setswitchinterval(switch)
    assert st.submitted == len(cases)
    assert st.dispatched_requests == len(cases)
    assert st.timeouts == 0 and st.rejected == 0
    for (X, method, metric), res in zip(cases, results):
        assert res.meta.method == method
        assert _same_result(res, _solo(X, method, metric)), \
            f"served {method} n={X.shape[0]} diverged from solo"


@pytest.mark.parametrize("method", ["vat", "ivat"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "manhattan", "euclidean"])
def test_served_equals_reference_served_on_integer_data(method, metric):
    """On integer data the port's served vat/ivat results equal the
    reference's served ones: orders bit for bit, images by value (the
    CPU's vectorized sqrt may sit an ulp off XLA's, so euclidean images
    are held within one f32 ulp of their scale)."""
    Xs = [_int_blobs(n, seed=n) for n in (57, 63)]   # one bucket
    with _server(window_s=5.0, max_batch=2) as srv:
        got = [f.result(timeout=WAIT) for f in
               [srv.submit(X, method=method, metric=metric) for X in Xs]]
    with JTendencyServer(JServeConfig(window_s=5.0, max_batch=2)) as jsrv:
        want = [f.result(timeout=WAIT) for f in
                [jsrv.submit(X, method=method, metric=metric) for X in Xs]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.order.numpy(), np.asarray(w.order))
        for f in ("rstar", "ivat_image"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None)
            if a is None:
                continue
            b = np.asarray(b)
            if metric == "euclidean":
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=np.spacing(b.max()))
            else:
                np.testing.assert_array_equal(a.numpy(), b)


# ============================================== lifecycle ==============

def test_default_device_raises_without_a_gpu():
    """ServeConfig() runs on the card; on a machine without one the server
    raises the facade's RuntimeError before its thread starts."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default server runs")
    assert ServeConfig().device == "cuda"
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        TendencyServer(ServeConfig())
    assert set(threading.enumerate()) == before


def test_real_thread_deadline_timeout():
    with _server(window_s=30.0) as srv:
        fut = srv.submit(_blobs(50), timeout_s=0.05)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=10)
        deadline = time.monotonic() + 10
        while srv.stats().timeouts == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.stats().timeouts == 1


def test_server_backpressure_leaves_queued_request_servable():
    srv = _server(window_s=30.0, max_pending=1)
    try:
        fut = srv.submit(_blobs(50))
        with pytest.raises(Backpressure):
            srv.submit(_blobs(70))
        assert srv.stats().rejected == 1
    finally:
        srv.close()
    assert _same_result(fut.result(timeout=WAIT), _solo(_blobs(50), "vat"))


def test_close_drains_queued_requests():
    srv = _server(window_s=30.0)
    try:
        fut = srv.submit(_blobs(50))
    finally:
        srv.close()
    assert _same_result(fut.result(timeout=WAIT), _solo(_blobs(50), "vat"))
    with pytest.raises(ServeError):
        srv.submit(_blobs(50))


def test_warm_cache_latency_strictly_below_cold(monkeypatch):
    """A warm fit never pays the build.  A build binds the fitter and runs
    nothing, so it is given a cost of 0.2 s here, which the cold request
    pays and no warm one does."""
    from repro_torch.serve import server as server_mod
    build = server_mod._build_program

    def slow_build(key, seed):
        time.sleep(0.2)
        return build(key, seed)

    monkeypatch.setattr(server_mod, "_build_program", slow_build)
    X = _blobs(50)
    with _server(window_s=0.001) as srv:
        t0 = time.perf_counter()
        srv.submit(X).result(timeout=WAIT)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            srv.submit(X).result(timeout=WAIT)
            warm.append(time.perf_counter() - t0)
    assert sorted(warm)[len(warm) // 2] < cold


def test_from_result_restores_the_facade_surface():
    X = _blobs(60)
    with _server(window_s=0.001) as srv:
        served = srv.submit(X).result(timeout=WAIT)
    fv = FastVAT.from_result(served, X=X)
    ref = FastVAT(method="vat", device=CPU).fit(X)
    assert np.array_equal(fv.order(), ref.order())
    assert np.array_equal(fv.image(), ref.image())
    assert fv.assess() == ref.assess()


def test_drift_window_reports_a_state():
    with _server(window_s=0.001, drift_window=4) as srv:
        assert srv.stats().drift == "OK"
        for s in range(5):
            srv.submit(_blobs(50, seed=s)).result(timeout=WAIT)
        assert srv.stats().drift in ("OK", "WARN", "COLLAPSE")


# ============================================== command line ===========

def _cli(module, *args):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_serve_launcher_smoke_on_cpu():
    out = _cli("repro_torch.launch.serve", "--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "16 requests x 4 clients" in out.stdout
    assert "p50" in out.stdout and "p99" in out.stdout
    assert "coalesce rate" in out.stdout and "timeouts 0" in out.stdout

"""TendencyServer — the tendency-as-a-service front door, on the card; the
reference's ``repro/serve/server.py``.

Composes the three serving mechanisms into one object:

  * :class:`~repro_torch.serve.cache.ProgramCache` — fit programs (the
    rung's batched fitter bound to one key's meta and options),
    LRU-bounded; eager PyTorch compiles nothing a shape, so a program's
    build does no device work, and a server on the card loads the kernel
    library (nvcc at its first use) once, when it starts;
  * :mod:`~repro_torch.serve.bucketing` — power-of-2 shape buckets with
    ordering-exact dup-row-0 padding, collapsing shape diversity onto a
    small program set;
  * :class:`~repro_torch.serve.coalesce.CoalescerCore` — same-bucket
    requests within a window ride one batched ``fit_batch`` dispatch.

Routing: ``method="auto"`` without an SLO uses the registry's
size-based policy (``select_method`` over the batch-capable rungs);
with ``slo_ms`` it asks the cost-model router
(``select_method_for_slo``) for the highest-fidelity rung the latency
budget affords.

Rung coverage: the servable set is the batch-capable rungs — vat, ivat,
flashvat.  vat/ivat are row-padded to n-buckets (the padding is proven
ordering-exact; see bucketing.py); flashvat programs key on the EXACT n
because its band-render shapes (group sizes, representative count) are
functions of n itself — flashvat still benefits from program reuse
across requests of the same n and from batch-lane coalescing.

Every served result is bitwise-identical to the solo
``FastVAT(..., device=...).fit(X)`` result, its tensors on the fit's
device — tests/test_torch_serve.py pins this on the CPU across rungs,
metrics, and concurrent mixed-shape load, and chip_smoke.py on the card.

The server runs on ``ServeConfig.device`` (default "cuda": the CUDA
kernels); without a GPU it raises ``RuntimeError`` before its thread
starts rather than carry on on the CPU.  ``device="cpu"`` runs the plain
PyTorch versions.

Threading model: ``submit`` enqueues under one condition variable and
returns a ``concurrent.futures.Future``; a single daemon dispatcher
thread replays coalescer events and executes ready batches OUTSIDE the
lock (builds and runs never block submitters), each batch under the
device's scope, and synchronizes the device before it unpacks.  All
scheduling decisions live in the clock-free ``CoalescerCore``, so the
identical logic is driven by the virtual-clock rig in tests with zero
real sleeps.

>>> import numpy as np
>>> from repro_torch.serve import ServeConfig, TendencyServer
>>> rng = np.random.default_rng(0)
>>> X = rng.normal(size=(100, 4)).astype(np.float32)
>>> with TendencyServer(ServeConfig(device="cpu")) as srv:
...     res = srv.fit(X)                       # submit().result()
...     same = srv.fit(X)                      # warm cache, zero builds
>>> bool((res.order == same.order).all())
True
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch import faults
from repro_torch.api.facade import _device
from repro_torch.api.metrics import validate_metric
from repro_torch.api.registry import (RungOptions, get_rung, select_method,
                                      select_method_for_slo)
from repro_torch.api.result import ResultMeta, TendencyResult, device_scope
from repro_torch.api.validation import InvalidInput, validate_points
from repro_torch.core.vat import block_structure_score
from repro_torch.kernels import _build
from repro_torch.numerics import NumericsPolicy
from repro_torch.numerics import resolve as resolve_numerics
from repro_torch.serve.bucketing import (bucket_batch, bucket_n,
                                         ensure_bucketable, pack_batch,
                                         real_positions, restrict)
from repro_torch.serve.cache import (CacheStats, ProgramCache, ProgramKey,
                                     mesh_fingerprint)
from repro_torch.serve.coalesce import (Batch, CoalescerCore,
                                        DeadlineExceeded, ExecutionError,
                                        ServeError, ServeRequest)
from repro_torch.serve.resilience import (CLOSED, BreakerConfig,
                                          CircuitBreaker, ResilienceCounters,
                                          ResilienceStats, RetryPolicy,
                                          breaker_family, fallback_chain)

#: Rungs the server dispatches — exactly the batch-capable registry set.
SERVABLE = ("vat", "ivat", "flashvat")
#: Rungs whose rows may be padded to n-buckets (ordering-exact dup-row
#: padding); flashvat is excluded — its band-render shapes depend on the
#: exact n, so its programs key on n itself.
PADDED_RUNGS = ("vat", "ivat")

# Build census: one count a program build (``_build_program``), the
# counterpart of the reference's trace counter — serving from a warm
# cache leaves it untouched, which the census tests pin.
_TRACE_CENSUS = {"traces": 0}


def trace_census() -> dict:
    """Copy of the build counters ({"traces": programs built})."""
    return dict(_TRACE_CENSUS)


def reset_trace_census() -> None:
    """Zero the build counters (test isolation)."""
    _TRACE_CENSUS["traces"] = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Server knobs — everything that shapes programs or scheduling.

    Attributes:
      window_s: coalescing window in seconds — a bucket's first request
        waits at most this long for companions.
      max_batch: a group dispatches immediately at this many requests.
      max_pending: bounded-queue limit; past it ``submit`` raises
        :class:`~repro_torch.serve.coalesce.Backpressure`.
      cache_capacity: LRU bound of the program cache.
      sample_size: flashvat's rendered representative count (key
        material — it changes the render's shapes).
      seed: the single seed of every program's ResultMeta — served
        results match solo fits of the same seed.
      drift_window: opt-in serving-side drift detection (0 = off, the
        default).  When > 0, every served result's (block_score, k_est)
        summary feeds a ``repro_torch.monitor.drift.DriftDetector`` whose
        StreamingVAT window (on the server's device) holds this many
        summaries; the current OK/WARN/COLLAPSE state is surfaced on
        ``stats().drift``.
      validate: admission-check every submitted X (finite, real dtype,
        n >= 4, non-degenerate) and refuse poison with the typed
        :class:`~repro_torch.api.validation.InvalidInput` *before* it can
        join a coalesced batch (rejects counted on
        ``stats().resilience.invalid_rejects``).
      retry: bounded jittered retry schedule applied at each fallback
        level (see ``repro_torch.serve.resilience``).
      breaker: circuit-breaker thresholds; after ``breaker.threshold``
        consecutive primary failures a key family is pinned to its
        fallback chain until ``breaker.cooldown_s`` elapses on the
        server clock, then re-probed once.
      numerics: the numerics shield's policy
        (``repro_torch.numerics.NumericsPolicy``) applied host-side to
        every submitted X before it can join a batch.  The resolved plan
        (tile form, storage dtype) becomes key material
        (``ProgramKey.num_form`` / ``num_dtype``), the per-request report
        is stamped on each unpacked result's meta, and bf16 certification
        fallbacks are counted on ``stats().resilience.numerics_fallbacks``.
        A bf16 lane is packed as f32 values bf16 represents exactly,
        which every kernel reads as the solo bf16 fit does.
      device: where programs run — "cuda" (default) launches the CUDA
        kernels, "cpu" runs their plain PyTorch versions (key material).
    """
    window_s: float = 0.002
    max_batch: int = 8
    max_pending: int = 256
    cache_capacity: int = 32
    sample_size: int = 256
    seed: int = 0
    drift_window: int = 0
    validate: bool = True
    retry: RetryPolicy = RetryPolicy()
    breaker: BreakerConfig = BreakerConfig()
    numerics: NumericsPolicy = NumericsPolicy()
    device: str = "cuda"


def resolve_key(n: int, d: int, *, method: str = "auto",
                metric: str = "euclidean",
                config: ServeConfig = ServeConfig(),
                slo_ms: float | None = None,
                mesh: str | None = None,
                num_form: str = "gram",
                num_dtype: str = "f32") -> ProgramKey:
    """Route a request shape to its program-cache group key.

    Pure function of its arguments (no server state), so tests and the
    virtual-clock rig build keys exactly the way ``submit`` does.

    Args:
      n, d: the request's real shape.
      method: "auto" or a name in :data:`SERVABLE`.
      metric: dissimilarity metric (``precomputed`` is rejected — see
        ``ensure_bucketable``).
      config: the server's program-shaping knobs (its device included).
      slo_ms: latency budget in milliseconds; with ``method="auto"``
        routes through the cost-model router instead of the size policy.
      mesh: device-set fingerprint override (defaults to the live one of
        ``config.device``).
      num_form / num_dtype: the numerics shield's resolved plan for the
        request's data (``numerics.resolve``) — key material, since the
        tile form and storage precision reach the kernels.

    Returns:
      The group :class:`ProgramKey` with ``b_bucket=0`` (lane count is
      bound at dispatch via ``with_batch``).

    Raises:
      ValueError: unservable metric/method, or n beyond every servable
        rung's auto window.
    """
    validate_metric(metric)
    ensure_bucketable(metric)
    if method == "auto":
        if slo_ms is not None:
            method = select_method_for_slo(n, slo_ms * 1e3,
                                           restrict=SERVABLE)
        else:
            try:
                method = select_method(n, batched=True, strict=True)
            except LookupError:
                raise ValueError(
                    f"n={n} exceeds every servable rung's window "
                    f"(servable: {list(SERVABLE)}); fit it directly via "
                    "FastVAT (the approx rung has no batched fitter "
                    "yet)") from None
    if method not in SERVABLE:
        raise ValueError(f"the serving layer dispatches {list(SERVABLE)}, "
                         f"got method={method!r}")
    n_bucket = bucket_n(n) if method in PADDED_RUNGS else n
    return ProgramKey(rung=method, b_bucket=0, n_bucket=n_bucket, d=d,
                      metric=metric,
                      mesh=(mesh if mesh is not None
                            else mesh_fingerprint(config.device)),
                      sample_size=config.sample_size,
                      num_form=num_form, num_dtype=num_dtype,
                      device=config.device)


def _build_program(key: ProgramKey, seed: int):
    """Build the batched fit program for a concrete ProgramKey.

    The program is the rung's ``fit_batch`` bound to the key's
    ``ResultMeta`` and ``RungOptions``: nothing is compiled for a shape,
    so the build runs nothing on the device.  One build is one count of
    the census.
    """
    if key.b_bucket < 1:
        raise ValueError(f"program wants a concrete lane count, got "
                         f"b_bucket={key.b_bucket} (call with_batch first)")
    faults.fault_point("serve.build", context={"key": key,
                                               "rung": key.rung,
                                               "device": key.device})
    rung = get_rung(key.rung)
    dev = torch.device(key.device)
    meta = ResultMeta(method=key.rung, metric=key.metric, n=key.n_bucket,
                      batch=key.b_bucket, seed=seed, device=str(dev),
                      sample_size=key.sample_size)
    opts = RungOptions(sample_size=key.sample_size, turbo=key.turbo,
                       num_form=key.num_form)

    def program(Xs: torch.Tensor) -> TendencyResult:
        return rung.fit_batch(Xs, meta, opts)

    _TRACE_CENSUS["traces"] += 1
    return program


def _lane(t: torch.Tensor | None, lane: int) -> torch.Tensor | None:
    """Lane ``lane`` of a batched field as a tensor of its own, so a
    served result does not keep the whole batch's memory alive."""
    return None if t is None else t[lane].clone()


def _unpack(key: ProgramKey, res: TendencyResult, lane: int,
            n: int, seed: int, numerics=None) -> TendencyResult:
    """Extract one request's solo-equivalent result from a batched fit.

    For the padded rungs the real-point subsequence of the padded
    ordering IS the unpadded ordering (bucketing.py's dup-row
    argument), so selecting the lane at the real positions reproduces the
    solo fit bitwise; the selection runs on the fit's device.  flashvat
    lanes are unpadded — take the lane.  ``numerics`` is the request's
    own resolved plan (NumericsReport), stamped on the solo-equivalent
    meta exactly where FastVAT stamps it.
    """
    dev = res.order.device
    meta = ResultMeta(method=key.rung, metric=key.metric, n=n, batch=None,
                      seed=seed, device=str(dev),
                      sample_size=key.sample_size, numerics=numerics)
    if key.rung in PADDED_RUNGS:
        order_pad = res.order[lane]
        pos = real_positions(order_pad, n)
        iv = res.ivat_image
        return TendencyResult(
            order=order_pad.index_select(0, pos),
            rstar=restrict(res.rstar[lane], pos),
            ivat_image=None if iv is None else restrict(iv[lane], pos),
            sample_idx=None, extension_labels=None, meta=meta)
    return TendencyResult(
        order=_lane(res.order, lane), rstar=_lane(res.rstar, lane),
        ivat_image=_lane(res.ivat_image, lane),
        sample_idx=_lane(res.sample_idx, lane),
        extension_labels=_lane(res.extension_labels, lane),
        group_sizes=res.group_sizes, meta=meta)


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Point-in-time server counters (scheduler + program cache).

    ``drift`` is the serving-side tendency drift state ("OK" / "WARN" /
    "COLLAPSE") when ``ServeConfig.drift_window`` is enabled, else None.
    ``resilience`` carries the degradation-ladder counters (fallbacks,
    splits, retries, breaker state, admission rejects) — all zero /
    empty on a healthy server; see ``repro_torch.serve.resilience``.
    """
    cache: CacheStats
    submitted: int
    dispatched_batches: int
    dispatched_requests: int
    timeouts: int
    rejected: int
    pending: int
    drift: str | None = None
    resilience: ResilienceStats = ResilienceStats()

    @property
    def coalesce_rate(self) -> float:
        """Mean requests per dispatched batch (1.0 = no coalescing)."""
        if not self.dispatched_batches:
            return 0.0
        return self.dispatched_requests / self.dispatched_batches


class TendencyServer:
    """Coalescing, program-cached cluster-tendency server (see module doc).

    Args:
      config: scheduling + program-shaping knobs, the device included.
      clock: monotonic time source — injectable so the deterministic
        rig can drive the same scheduling logic with a virtual clock.
      sleep: blocking wait used for retry backoff (and armed delay
        faults) — injectable alongside ``clock`` so chaos tests advance
        a virtual clock instead of really sleeping.

    Raises:
      RuntimeError: ``config.device`` is a CUDA device and
        ``torch.cuda.is_available()`` is False (before any thread
        starts).
    """

    def __init__(self, config: ServeConfig = ServeConfig(), *,
                 clock=time.monotonic, sleep=time.sleep):
        self._device = _device(config.device)
        if self._device.type == "cuda":
            _build.library()
        self.config = config
        self._clock = clock
        self._sleep = sleep
        self._drift = None
        if config.drift_window > 0:
            from repro_torch.monitor.drift import DriftConfig, DriftDetector
            self._drift = DriftDetector(
                DriftConfig(window=config.drift_window),
                device=config.device)
        self._cache = ProgramCache(capacity=config.cache_capacity)
        self._core = CoalescerCore(window=config.window_s,
                                   max_batch=config.max_batch,
                                   max_pending=config.max_pending)
        self._counters = ResilienceCounters()
        self._breakers: dict[str, CircuitBreaker] = {}
        self._cv = threading.Condition()
        self._ready: deque[Batch] = deque()
        self._inflight: list[ServeRequest] = []
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tendency-serve-dispatch")
        self._thread.start()

    # ---------------------------------------------------------- submit ----

    def submit(self, X, *, metric: str = "euclidean",
               method: str = "auto", slo_ms: float | None = None,
               timeout_s: float = 30.0, tag=None) -> Future:
        """Enqueue one fit; returns a Future of its TendencyResult.

        Args:
          X: (n, d) feature matrix (array-like, on the host).
          metric: dissimilarity metric (not "precomputed").
          method: "auto" (size/SLO routed) or a :data:`SERVABLE` name.
          slo_ms: latency budget for the cost-model router.
          timeout_s: per-request deadline; still queued past it => the
            future fails with :class:`DeadlineExceeded`.
          tag: caller label, carried on the request (test bookkeeping).

        Returns:
          Future resolving to a solo-equivalent
          :class:`~repro_torch.api.result.TendencyResult` whose tensors
          are on the server's device.

        Raises:
          InvalidInput: admission refused X (non-finite / bad dtype /
            degenerate) — the request never reached a batch.
          Backpressure: the bounded queue is full.
          ServeError: the server is closed.
          ValueError: unservable shape/metric/method.
        """
        if self.config.validate:
            try:
                validate_points(X, metric=metric)
            except InvalidInput:
                self._counters.bump("invalid_rejects")
                raise
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"submit wants an (n, d) matrix, got shape "
                             f"{X.shape}")
        # The numerics shield runs host-side at admission, exactly like
        # the solo facade: X becomes the conditioned (possibly bf16
        # -quantized) copy and the resolved plan keys the program, so a
        # direct-form request can never ride a Gram-form batch.
        X, num_report = resolve_numerics(X, metric=metric,
                                         policy=self.config.numerics)
        if num_report.fallbacks:
            self._counters.bump("numerics_fallbacks", num_report.fallbacks)
        n, d = int(X.shape[0]), int(X.shape[1])
        key = resolve_key(n, d, method=method, metric=metric,
                          config=self.config, slo_ms=slo_ms,
                          num_form=num_report.form,
                          num_dtype=num_report.dtype)
        now = self._clock()
        req = ServeRequest(X=X, n=n, key=key, arrival=now,
                           deadline=now + timeout_s, future=Future(),
                           tag=tag, numerics=num_report)
        # Poll-then-enqueue: due flushes/expiries are pulled out of the
        # core and handed to the dispatcher BEFORE the bound check, so a
        # Backpressure rejection can never strand a flushed batch (its
        # futures would otherwise hang forever).  Expired futures are
        # failed outside the lock on every exit path.
        expired: list[ServeRequest] = []
        try:
            with self._cv:
                if self._closed:
                    raise ServeError("server is closed")
                try:
                    batches, expired = self._core.poll(now)
                    self._ready.extend(batches)
                    flush = self._core.try_enqueue(req, now)
                    if flush is not None:
                        self._ready.append(flush)
                finally:
                    self._cv.notify()
        finally:
            for r in expired:
                self._fail_expired(r)
        return req.future

    def fit(self, X, **kwargs) -> TendencyResult:
        """Synchronous convenience: ``submit(X, **kwargs).result()``."""
        return self.submit(X, **kwargs).result()

    def warm(self, n: int, d: int, *, metric: str = "euclidean",
             method: str = "auto", slo_ms: float | None = None,
             batch: int = 1, num_form: str = "gram",
             num_dtype: str = "f32") -> ProgramKey:
        """Build the program a future (n, d) request will hit (its
        binding: the build runs nothing on the device).

        Pass the same ``slo_ms`` the requests will carry: with an SLO
        the router may pick a different rung than the size policy, and
        warming must target the key those requests resolve to or they
        pay the build on the serving path anyway.  Likewise ``num_form``
        / ``num_dtype``: requests whose data resolves to a direct-form or
        bf16 plan hit a different program — warm with the plan
        ``numerics.resolve`` will produce for the real data.

        Returns the concrete (batched) ProgramKey that was built — a
        subsequent matching request is a pure cache hit.
        """
        key = resolve_key(n, d, method=method, metric=metric,
                          config=self.config, slo_ms=slo_ms,
                          num_form=num_form,
                          num_dtype=num_dtype).with_batch(bucket_batch(batch))
        self._cache.get(key, lambda: _build_program(key, self.config.seed))
        return key

    # ----------------------------------------------------- introspection --

    def stats(self) -> ServeStats:
        with self._cv:
            return ServeStats(cache=self._cache.stats(),
                              submitted=self._core.submitted,
                              dispatched_batches=self._core.dispatched_batches,
                              dispatched_requests=self._core.dispatched_requests,
                              timeouts=self._core.timeouts,
                              rejected=self._core.rejected,
                              pending=self._core.pending,
                              drift=(None if self._drift is None
                                     else self._drift.state),
                              resilience=self._counters.snapshot(
                                  self._breakers))

    def breaker_state(self, n: int, d: int, *, metric: str = "euclidean",
                      method: str = "auto",
                      slo_ms: float | None = None) -> str:
        """Breaker state ("CLOSED"/"OPEN"/"HALF_OPEN") for the key
        family an (n, d) request resolves to — introspection for tests
        and the chaos CLI."""
        key = resolve_key(n, d, method=method, metric=metric,
                          config=self.config, slo_ms=slo_ms)
        b = self._breakers.get(breaker_family(key))
        return CLOSED if b is None else b.state

    # --------------------------------------------------------- lifecycle --

    def close(self) -> None:
        """Stop accepting work, drain queued requests, join the thread.

        Queued requests still within deadline are dispatched (possibly
        before their window elapsed); expired ones fail with
        DeadlineExceeded.
        """
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify()
        self._thread.join()

    def __enter__(self) -> "TendencyServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- internals --

    def _fail_expired(self, req: ServeRequest) -> None:
        if not req.future.done():
            req.future.set_exception(DeadlineExceeded(
                f"request (n={req.n}, rung={req.key.rung}) expired after "
                f"{req.deadline - req.arrival:.3f}s in queue"))

    def _run(self) -> None:
        """Dispatcher entry: run the loop; if it ever dies on an
        unexpected error, fail every outstanding future with a typed
        ServeError instead of leaving callers hanging on result()."""
        try:
            self._run_loop()
        except BaseException as exc:  # noqa: BLE001 — last-resort failsafe
            self._emergency_shutdown(exc)

    def _emergency_shutdown(self, exc: BaseException) -> None:
        """The dispatcher died: close the server and fail everything
        queued (core groups, ready batches) so no future hangs."""
        stranded: list[ServeRequest] = []
        with self._cv:
            self._closed = True
            try:
                batches, expired = self._core.drain(float("inf"))
            except Exception:  # noqa: BLE001 — even a broken core drains
                batches, expired = [], []
                for reqs in getattr(self._core, "_groups", {}).values():
                    stranded.extend(reqs)
            for b in list(self._ready) + list(batches):
                stranded.extend(b.requests)
            stranded.extend(expired)
            stranded.extend(self._inflight)   # the batch that killed us
            self._ready.clear()
            self._inflight = []
        for req in stranded:
            if not req.future.done():
                req.future.set_exception(ServeError(
                    f"dispatcher thread died: {exc!r}"))

    def _run_loop(self) -> None:
        """Dispatcher loop: replay coalescer events, execute batches
        outside the lock, exit after a drained close."""
        while True:
            with self._cv:
                while True:
                    now = self._clock()
                    batches, expired = self._core.poll(now)
                    self._ready.extend(batches)
                    if self._ready or expired or self._closed:
                        break
                    event = self._core.next_event()
                    wait = (None if event is None
                            else max(0.0, event[0] - now))
                    self._cv.wait(timeout=wait)
                if self._closed:
                    drained, late = self._core.drain(self._clock())
                    self._ready.extend(drained)
                    expired = list(expired) + late
                todo = list(self._ready)
                self._ready.clear()
                # Track the pulled batches: if _execute dies on a
                # BaseException, _emergency_shutdown must still see (and
                # fail) these requests — they are in no other structure.
                self._inflight = [r for b in todo for r in b.requests]
                closed = self._closed
            for req in expired:
                self._fail_expired(req)
            for batch in todo:
                with device_scope(self._device):
                    self._execute(batch)
            with self._cv:
                self._inflight = []
            if closed:
                return

    def _execute(self, batch: Batch) -> None:
        """Serve one flushed batch through the degradation ladder.

        Order of defenses (see ``repro_torch.serve.resilience``):

          1. dispatch the whole batch down the fallback chain with
             bounded retries (breaker-gated primary);
          2. if the *batch* still fails and has >1 lanes, split it and
             retry every lane solo — one poison request must not take
             its batchmates down (their solo results are produced by
             the identical program family, so they stay bitwise-equal
             to their solo fits);
          3. a single lane that exhausts the ladder fails its future
             with the typed :class:`ExecutionError` — never the thread.
        """
        requests = [r for r in batch.requests if not r.future.done()]
        if not requests:
            return
        try:
            res, used_key = self._dispatch_ladder(batch.key, requests)
        except Exception as exc:  # noqa: BLE001 — ladder exhausted
            if len(requests) > 1:
                self._counters.bump("splits")
                for req in requests:
                    self._execute(Batch(key=batch.key, requests=[req],
                                        created=batch.created))
                return
            self._counters.bump("failed")
            err = ExecutionError(
                f"request (n={requests[0].n}, rung={batch.key.rung}) "
                f"failed after exhausting the degradation ladder: {exc!r}")
            err.__cause__ = exc
            requests[0].future.set_exception(err)
            return
        for lane, req in enumerate(requests):
            lane_res = _unpack(used_key, res, lane, req.n,
                               self.config.seed, req.numerics)
            if self._drift is not None:
                # drift only runs on the dispatcher thread; stats()
                # reads the state attribute (GIL-atomic) elsewhere
                score, k = block_structure_score(lane_res.rstar)
                self._drift.update(float(score), float(k))
            req.future.set_result(lane_res)

    def _breaker(self, family: str) -> CircuitBreaker:
        b = self._breakers.get(family)
        if b is None:
            b = CircuitBreaker(self.config.breaker)
            self._breakers[family] = b
        return b

    def _run_once(self, key: ProgramKey,
                  requests: list[ServeRequest]) -> TendencyResult:
        """One program dispatch attempt at a concrete chain level: pack on
        the host, one copy to the device, the program, and a device
        synchronize, so the attempt's errors and its time end here."""
        faults.fault_point(
            "serve.execute",
            context={"key": key, "lanes": len(requests),
                     "tags": [r.tag for r in requests]},
            sleep=self._sleep)
        program = self._cache.get(
            key, lambda: _build_program(key, self.config.seed))
        packed = pack_batch([r.X for r in requests],
                            key.n_bucket, key.b_bucket)
        res = program(torch.from_numpy(packed).to(self._device))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return res

    def _dispatch_ladder(self, group_key: ProgramKey,
                         requests: list[ServeRequest]):
        """Fallback chain + bounded retry + circuit breaker.

        Returns (batched TendencyResult, the concrete key that served
        it); raises the last underlying error when every level of the
        chain is exhausted.  Counter semantics (pinned by the chaos
        suite): ``retries`` += 1 per same-level re-attempt,
        ``fallbacks`` += 1 per level transition (including the
        breaker-pinned skip of the primary), ``degraded`` += lanes
        served by a non-primary level.
        """
        b = bucket_batch(len(requests))
        chain = [k.with_batch(b) for k in fallback_chain(group_key)]
        breaker = self._breaker(breaker_family(group_key))
        start = 0
        if len(chain) > 1 and not breaker.allow_primary(self._clock()):
            start = 1                      # pinned to the fallback chain
            self._counters.bump("fallbacks")
        last_exc: Exception | None = None
        for level in range(start, len(chain)):
            key = chain[level]
            for attempt in range(self.config.retry.max_attempts):
                if attempt:
                    self._counters.bump("retries")
                    self._sleep(self.config.retry.delay_s(
                        attempt - 1, seed=self.config.seed))
                try:
                    res = self._run_once(key, requests)
                except Exception as exc:  # noqa: BLE001 — degrade, don't die
                    last_exc = exc
                    continue
                if level == 0:
                    breaker.record_success(self._clock())
                else:
                    self._counters.bump("degraded", len(requests))
                return res, key
            if level == 0:
                breaker.record_failure(self._clock())
            if level + 1 < len(chain):
                self._counters.bump("fallbacks")
        if last_exc is None:
            raise ServeError("the fallback chain ran no level")
        raise last_exc

"""Graceful-degradation ladder for the serving layer; the reference's
``repro/serve/resilience.py``.

The serving layer's promise upgrades here from "fast and bitwise-correct
when everything works" to "stays up and *observably* degrades when
something doesn't".  Four mechanisms, composed by
``TendencyServer._execute``:

1. **Batch-failure isolation** — when a coalesced batch's execute
   raises, the batch is split and every lane retried solo, so one
   poison request fails alone and its batchmates still get their
   bitwise-correct results (the split lanes run the identical program
   family the clean path uses).

2. **Per-key fallback chain** (:func:`fallback_chain`) — an ordered
   ladder of degraded :class:`~repro_torch.serve.cache.ProgramKey`
   variants: a flashvat key falls from the persistent kernel to the
   stepwise one (``turbo=False``: one hand-written kernel to another),
   and an ivat key steps down one fidelity rung to vat (same n-bucket,
   same padding proof, coarser image).  Every transition is a *served
   result instead of an error* and increments ``fallbacks``.  There is
   no step from a CUDA kernel to its plain PyTorch version: that would
   run the plain version on the card when a kernel fails, which is a
   failure hidden, not a fallback.

3. **Bounded jittered retry** (:class:`RetryPolicy`) — each chain level
   gets ``max_attempts`` tries with exponential backoff; the jitter is
   deterministic in (seed, attempt) so the chaos tests can pin exact
   schedules, and the wait runs through the server's injectable sleep
   so virtual-clock rigs never really sleep.

4. **Circuit breaker** (:class:`CircuitBreaker`) — ``threshold``
   consecutive primary-level dispatch failures open the breaker: the
   primary is skipped (requests go straight to the fallback chain)
   until ``cooldown_s`` elapses on the injectable clock, after which
   ONE probe dispatch re-tries the primary (HALF_OPEN); success closes
   the breaker, failure re-opens it for another cooldown.  The machine
   is clock-free — every transition takes ``now`` — mirroring
   ``CoalescerCore`` so the same virtual-clock rig drives it.

Every degradation increments a typed counter on
:class:`ResilienceCounters`; the snapshot (:class:`ResilienceStats`)
surfaces on ``ServeStats.resilience`` so tests and the chaos CLI pin
exact trajectories.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.serve.cache import ProgramKey

# breaker states
CLOSED = "CLOSED"
OPEN = "OPEN"
HALF_OPEN = "HALF_OPEN"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    Attributes:
      max_attempts: tries per chain level (1 = no retry).
      backoff_s: base delay before the first retry.
      backoff_cap_s: upper bound on any single delay (pre-jitter).
      jitter: +-relative jitter applied to each delay, drawn
        deterministically from (seed, attempt) — bounded, reproducible,
        and still decorrelating real concurrent retries.
    """

    max_attempts: int = 2
    backoff_s: float = 0.005
    backoff_cap_s: float = 0.1
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")

    def delay_s(self, attempt: int, *, seed: int = 0) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        base = min(self.backoff_cap_s, self.backoff_s * (2.0 ** attempt))
        if self.jitter <= 0:
            return base
        rng = np.random.default_rng(np.random.SeedSequence([seed, attempt]))
        frac = float(rng.uniform(-self.jitter, self.jitter))
        return base * (1.0 + frac)


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker thresholds (see module docstring)."""

    threshold: int = 3      # consecutive primary failures that open it
    cooldown_s: float = 30.0


class CircuitBreaker:
    """Clock-free CLOSED -> OPEN -> HALF_OPEN state machine, per key."""

    def __init__(self, config: BreakerConfig = BreakerConfig()):
        self.config = config
        self.state = CLOSED
        self.failures = 0        # consecutive primary dispatch failures
        self.opened_at: float | None = None
        self.opens = 0           # lifetime transitions into OPEN
        self.probes = 0          # lifetime HALF_OPEN probe dispatches

    def allow_primary(self, now: float) -> bool:
        """May this dispatch try the primary level?  OPEN past cooldown
        moves to HALF_OPEN and admits exactly one probe."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if now - self.opened_at >= self.config.cooldown_s:
                self.state = HALF_OPEN
                self.probes += 1
                return True
            return False
        # HALF_OPEN: a probe is already in flight on this dispatcher
        # thread; concurrent dispatches stay on the fallback.
        return False

    def record_success(self, now: float) -> None:
        self.failures = 0
        self.state = CLOSED
        self.opened_at = None

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if (self.state == HALF_OPEN
                or self.failures >= self.config.threshold):
            if self.state != OPEN:
                self.opens += 1
            self.state = OPEN
            self.opened_at = now


def fallback_chain(key: ProgramKey) -> tuple[ProgramKey, ...]:
    """The ordered program ladder for one group key, primary first.

    Degradation moves (applied cumulatively, each a strictly "more
    boring" configuration):

      flashvat turbo   -> turbo=False            (persistent -> stepwise
                                                  kernel, same bits)
      rung "ivat"      -> "vat"                  (geodesic -> raw image;
                                                  same n-bucket, same
                                                  dup-row padding proof)

    The reference's first move, ``use_pallas=True -> False``, has no
    counterpart: a program on the card launches the CUDA kernels and
    nothing else, and a step to the plain PyTorch versions would run them
    on the card whenever a kernel fails.  No level differs from the one
    before it in ``device`` or ``mesh``.

    The rung step-down preserves the bucketing contract: ivat and vat
    share ``PADDED_RUNGS`` semantics, so a vat fallback still unpacks
    each lane bitwise-equal to its solo vat fit.  vat itself has no
    lower padded rung, and flashvat's band-render shapes key on exact n,
    so neither steps further down.
    """
    chain = [key]
    k = key
    if k.rung == "flashvat" and k.turbo is not False:
        k = dataclasses.replace(k, turbo=False)
        chain.append(k)
    if k.rung == "ivat":
        k = dataclasses.replace(k, rung="vat")
        chain.append(k)
    return tuple(chain)


@dataclasses.dataclass(frozen=True)
class ResilienceStats:
    """Point-in-time degradation counters (on ``ServeStats.resilience``).

    Attributes:
      fallbacks: chain-level transitions taken (primary -> level 1,
        level 1 -> level 2, ...) across all dispatches.
      splits: failed multi-lane batches split into solo retries.
      retries: same-level re-attempts after a failure.
      degraded: requests served by a non-primary chain level (every one
        of these was an error turned into a result).
      breaker_opens: breaker transitions into OPEN.
      breaker_probes: HALF_OPEN probe dispatches after cooldown.
      invalid_rejects: requests refused at admission (InvalidInput).
      failed: futures ultimately failed after the whole ladder.
      numerics_fallbacks: requests whose bf16 storage request failed
        certification (or was fault-tripped) and was served at f32
        instead — the numerics shield's counted degradation (mirrors
        ``NumericsReport.fallbacks``; see repro_torch.numerics).
      breakers: sorted (key-family, state) pairs of every breaker whose
        state is not CLOSED — empty on a healthy server.
    """

    fallbacks: int = 0
    splits: int = 0
    retries: int = 0
    degraded: int = 0
    breaker_opens: int = 0
    breaker_probes: int = 0
    invalid_rejects: int = 0
    failed: int = 0
    numerics_fallbacks: int = 0
    breakers: tuple[tuple[str, str], ...] = ()

    @property
    def open_breakers(self) -> int:
        return sum(1 for _, s in self.breakers if s == OPEN)


class ResilienceCounters:
    """Mutable counter block the server increments; lock-guarded since
    submit (rejects) and the dispatcher (everything else) both write."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fallbacks = 0
        self.splits = 0
        self.retries = 0
        self.degraded = 0
        self.invalid_rejects = 0
        self.failed = 0
        self.numerics_fallbacks = 0

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def snapshot(self, breakers: dict[str, CircuitBreaker]) -> ResilienceStats:
        with self._lock:
            return ResilienceStats(
                fallbacks=self.fallbacks, splits=self.splits,
                retries=self.retries, degraded=self.degraded,
                breaker_opens=sum(b.opens for b in breakers.values()),
                breaker_probes=sum(b.probes for b in breakers.values()),
                invalid_rejects=self.invalid_rejects, failed=self.failed,
                numerics_fallbacks=self.numerics_fallbacks,
                breakers=tuple(sorted(
                    (name, b.state) for name, b in breakers.items()
                    if b.state != CLOSED)))


def breaker_family(key: ProgramKey) -> str:
    """Breaker identity for a group key: the program family minus the
    lane count — every batch size of one (rung, shape, knob) family
    shares failure history (a broken build is broken at every
    b_bucket)."""
    return (f"{key.rung}/n{key.n_bucket}/d{key.d}/{key.metric}/"
            f"device={key.device}/turbo={key.turbo}")

"""Request coalescer — a pure state machine; the reference's
``repro/serve/coalesce.py``.

Same-bucket requests arriving within a configurable window are packed
into one batched dispatch; the rung's batched fitter (``fit_batch``, the
kernels with a lane axis) then amortizes one program run across all of
them.  The scheduling logic lives
here as :class:`CoalescerCore`, a **clock-free** state machine: every
method takes the current time as an argument and returns the batches
that became ready.  Nothing in this module sleeps, spawns threads, or
reads a wall clock — that is what makes the deterministic concurrency
rig (tests/_torch_serve_clock.py) possible: tests inject arrival times and
assert exactly which requests land in which batch, with zero real
sleeps.  The threaded :class:`~repro_torch.serve.server.TendencyServer`
drives the same core with ``time.monotonic``.

Semantics (pinned by tests/test_torch_serve.py):

* A group opens when the first request for a ProgramKey arrives; it
  flushes at ``opened + window`` or immediately when it reaches
  ``max_batch``, whichever comes first.
* Each request carries an absolute ``deadline``; a request still
  queued at its deadline is expired with :class:`DeadlineExceeded`.
  At the instant ``deadline == flush`` the flush wins — the request
  rides the batch (events at equal time are ordered flush-first).
* ``max_pending`` bounds the total queued requests; past it
  ``try_enqueue`` raises :class:`Backpressure` instead of buffering
  unboundedly.  Dispatch latency is the caller's signal to shed load.
  The rejection has NO side effects on the queue: callers replay due
  events via ``poll(now)`` *before* enqueueing, so a rejected submit
  can never swallow batches or expiries the poll produced.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Any

from repro_torch.serve.cache import ProgramKey


class ServeError(RuntimeError):
    """Base class for serving-layer errors."""


class Backpressure(ServeError):
    """The bounded queue is full — retry later or shed load."""


class DeadlineExceeded(ServeError):
    """The request was still queued when its deadline passed."""


class ExecutionError(ServeError):
    """The request's dispatch failed after the whole degradation ladder
    (every fallback level, every retry) was exhausted.  ``__cause__``
    carries the last underlying error."""


@dataclasses.dataclass
class ServeRequest:
    """One queued fit request.

    Attributes:
      X: the (n, d) feature matrix as submitted (unpadded).
      n: real row count (needed to extract the unpadded result).
      key: group key — b_bucket is 0 until dispatch.
      arrival: submit time on the driving clock.
      deadline: absolute expiry time on the same clock.
      future: resolved with a TendencyResult-backed payload, or failed
        with DeadlineExceeded / the dispatch error.
      tag: optional caller-provided label (tests use it to identify
        requests in dispatch records).
      numerics: the request's resolved numerics plan
        (``repro_torch.numerics.NumericsReport`` — X above is already the
        conditioned/quantized copy it describes), stamped onto the
        unpacked result's meta; None when the server skipped the
        pre-pass.
    """
    X: Any
    n: int
    key: ProgramKey
    arrival: float
    deadline: float
    future: Future
    tag: Any = None
    numerics: Any = None


@dataclasses.dataclass
class Batch:
    """A flushed group ready for one batched dispatch."""
    key: ProgramKey
    requests: list[ServeRequest]
    created: float


class CoalescerCore:
    """Clock-free coalescing state machine (see module docstring).

    Args:
      window: coalescing window in clock units — a group flushes this
        long after it opened.
      max_batch: a group flushes immediately at this size.
      max_pending: total queued-request bound across all groups.
    """

    def __init__(self, window: float = 0.002, max_batch: int = 8,
                 max_pending: int = 256):
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.window = window
        self.max_batch = max_batch
        self.max_pending = max_pending
        self._groups: dict[ProgramKey, list[ServeRequest]] = {}
        self._opened: dict[ProgramKey, float] = {}
        # counters (exposed via server.stats())
        self.submitted = 0
        self.rejected = 0
        self.timeouts = 0
        self.dispatched_batches = 0
        self.dispatched_requests = 0

    @property
    def pending(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def _flush(self, key: ProgramKey, now: float) -> Batch:
        reqs = self._groups.pop(key)
        self._opened.pop(key)
        self.dispatched_batches += 1
        self.dispatched_requests += len(reqs)
        return Batch(key=key, requests=reqs, created=now)

    def _expire(self, now: float) -> list[ServeRequest]:
        expired = []
        for key in list(self._groups):
            reqs = self._groups[key]
            live = [r for r in reqs if r.deadline > now]
            if len(live) != len(reqs):
                expired.extend(r for r in reqs if r.deadline <= now)
                if live:
                    self._groups[key] = live
                else:
                    del self._groups[key]
                    del self._opened[key]
        self.timeouts += len(expired)
        return expired

    def poll(self, now: float) -> tuple[list[Batch], list[ServeRequest]]:
        """Advance the machine to ``now``.

        Replays every event with timestamp <= now in order.  Events at
        equal time are ordered flush-before-deadline, so a request
        whose deadline coincides with its group's flush rides the
        batch rather than expiring.

        Returns:
          (batches ready to dispatch, requests expired past deadline).
        """
        batches: list[Batch] = []
        expired: list[ServeRequest] = []
        while True:
            event = self.next_event()
            if event is None or event[0] > now:
                break
            t, kind, key = event
            if kind == 0:
                batches.append(self._flush(key, t))
            else:
                expired.extend(self._expire(t))
        return batches, expired

    def next_event(self) -> tuple[float, int, ProgramKey | None] | None:
        """Earliest pending event as ``(time, kind, key)``.

        kind 0 = group flush (at ``opened + window``), kind 1 = request
        deadline.  The tuple ordering doubles as the tie rule: at equal
        time the flush (kind 0) fires first.  None when idle.
        """
        events: list[tuple[float, int, ProgramKey | None]] = []
        for key, opened in self._opened.items():
            events.append((opened + self.window, 0, key))
        for key, reqs in self._groups.items():
            for r in reqs:
                events.append((r.deadline, 1, key))
        if not events:
            return None
        return min(events, key=lambda e: (e[0], e[1]))

    def try_enqueue(self, req: ServeRequest, now: float) -> Batch | None:
        """Enqueue one request at time ``now``; no implicit poll.

        Callers MUST call ``poll(now)`` first and handle its output —
        that replays due flushes/expiries before the queue-bound check,
        and it is what makes the Backpressure raise safe: a rejection
        here has no side effects beyond the ``rejected`` counter, so it
        can never discard batches whose futures would then hang.

        Returns:
          The group's batch when this request filled it to
          ``max_batch`` (flushed immediately), else None.

        Raises:
          Backpressure: ``max_pending`` requests are already queued.
            The queue state is untouched.
        """
        if self.pending >= self.max_pending:
            self.rejected += 1
            raise Backpressure(
                f"serving queue full ({self.max_pending} pending); "
                "retry later or raise max_pending")
        self.submitted += 1
        group = self._groups.setdefault(req.key, [])
        if req.key not in self._opened:
            self._opened[req.key] = now
        group.append(req)
        if len(group) >= self.max_batch:
            return self._flush(req.key, now)
        return None

    def drain(self, now: float) -> tuple[list[Batch], list[ServeRequest]]:
        """Flush every open group regardless of window (shutdown path).

        Expiry is applied first, so a request past deadline at drain
        time still fails with DeadlineExceeded rather than being fit.
        """
        expired = self._expire(now)
        batches = [self._flush(key, now) for key in list(self._groups)]
        return batches, expired

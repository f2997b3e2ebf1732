"""Deterministic concurrency rig for the port's serving layer, the
counterpart of ``tests/_serve_clock.py`` (it imports only ``repro_torch``).

The scheduling logic under test — coalescing windows, deadlines,
max-batch closure, backpressure — lives entirely in the clock-free
``repro_torch.serve.coalesce.CoalescerCore``: every transition takes "now" as
an argument.  This rig drives that state machine with a
:class:`VirtualClock`, so tests inject exact arrival times and assert
exactly which requests land in which batched dispatch — zero real
sleeps, zero threads, zero flake.

``TendencyServer`` drives the *same* core with ``time.monotonic``; the
threaded path is covered separately by real-thread stress tests in
test_torch_serve.py.  The rig records, never executes: dispatched batches are
collected as (time, key, tags) tuples and expired requests as
(time, tag), so assertions read like a schedule transcript.
"""
from __future__ import annotations

from concurrent.futures import Future

import numpy as np

from repro_torch.serve.bucketing import bucket_n
from repro_torch.serve.cache import ProgramKey
from repro_torch.serve.coalesce import CoalescerCore, ServeRequest


class VirtualClock:
    """A monotonic clock a test advances by hand."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"time only moves forward, got dt={dt}")
        self._t += dt
        return self._t

    def set(self, t: float) -> float:
        if t < self._t:
            raise ValueError(f"time only moves forward: {t} < {self._t}")
        self._t = float(t)
        return self._t


def make_key(n: int = 100, d: int = 4, *, rung: str = "vat",
             metric: str = "euclidean", mesh: str = "test:1",
             **overrides) -> ProgramKey:
    """A group ProgramKey the way resolve_key would build it, minus the
    live device-set lookup (tests pin the mesh string for determinism)."""
    n_bucket = bucket_n(n) if rung in ("vat", "ivat") else n
    return ProgramKey(rung=rung, b_bucket=0, n_bucket=n_bucket, d=d,
                      metric=metric, mesh=mesh, **overrides)


def make_request(tag, now: float, *, n: int = 100, d: int = 4,
                 timeout_s: float = 10.0,
                 key: ProgramKey | None = None) -> ServeRequest:
    """A ServeRequest with a tiny placeholder payload (the rig never
    executes batches, so X only needs the right shape)."""
    return ServeRequest(X=np.zeros((n, d), np.float32), n=n,
                        key=key if key is not None else make_key(n, d),
                        arrival=now, deadline=now + timeout_s,
                        future=Future(), tag=tag)


class CoalesceRig:
    """Drives a CoalescerCore on a VirtualClock, recording the schedule.

    Attributes:
      dispatches: list of (time, ProgramKey, [tags]) per flushed batch,
        in flush order.
      expired: list of (time, tag) per deadline-expired request.
    """

    def __init__(self, *, window: float = 1.0, max_batch: int = 8,
                 max_pending: int = 256, t0: float = 0.0):
        self.clock = VirtualClock(t0)
        self.core = CoalescerCore(window=window, max_batch=max_batch,
                                  max_pending=max_pending)
        self.dispatches: list[tuple[float, ProgramKey, list]] = []
        self.expired: list[tuple[float, object]] = []

    def _record(self, batches, expired) -> None:
        for b in batches:
            self.dispatches.append(
                (b.created, b.key, [r.tag for r in b.requests]))
        for r in expired:
            self.expired.append((r.deadline, r.tag))

    def submit(self, tag, t: float, *, n: int = 100, d: int = 4,
               timeout_s: float = 10.0,
               key: ProgramKey | None = None) -> ServeRequest:
        """Advance to t and submit one request, recording any resulting
        flushes/expiries. Returns the request for future inspection.

        Mirrors TendencyServer.submit's poll-then-enqueue protocol: due
        events are recorded BEFORE the bound check, so a Backpressure
        raise never swallows a dispatch.
        """
        self.clock.set(t)
        req = make_request(tag, t, n=n, d=d, timeout_s=timeout_s, key=key)
        self._record(*self.core.poll(t))
        flush = self.core.try_enqueue(req, t)   # may raise Backpressure
        if flush is not None:
            self._record([flush], [])
        return req

    def run_until(self, t: float) -> None:
        """Advance to t, replaying every due flush/deadline event."""
        self.clock.set(t)
        self._record(*self.core.poll(t))

    def drain(self, t: float) -> None:
        """Advance to t and flush everything (shutdown semantics)."""
        self.clock.set(t)
        self._record(*self.core.drain(t))

    def batch_tags(self) -> list[list]:
        """Just the tag lists, in dispatch order (the usual assertion)."""
        return [tags for _, _, tags in self.dispatches]

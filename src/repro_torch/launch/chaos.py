"""Chaos driver: scripted fault schedules against a live TendencyServer.

The command-line twin of tests/test_torch_resilience.py: each scenario
arms a deterministic fault schedule from ``repro_torch.faults``, drives
the real serving stack on a virtual clock (injected ``clock`` + ``sleep``
— zero real waits), and asserts the EXACT ``ServeStats.resilience``
counter trajectory plus bitwise-correct survivor results.  Any mismatch
prints the expectation diff and exits non-zero.

  PYTHONPATH=src python -m repro_torch.launch.chaos --smoke
  PYTHONPATH=src python -m repro_torch.launch.chaos --scenarios poison,breaker
  PYTHONPATH=src python -m repro_torch.launch.chaos --smoke --device cpu

Scenarios:

  poison     one poisoned lane of a 4-lane coalesced batch: batchmates
             bitwise-correct, the poison fails typed, split/retry
             counters pinned.
  fallback   a primary whose program build fails is served by the next
             level of the port's ladder: a flashvat primary by the
             stepwise kernel (``turbo=False``; on the card at 50,000 x 64,
             the top of flashvat's window, with its launches counted), an
             ivat primary by vat — never by a plain PyTorch version.
  breaker    repeated primary failures trip the breaker, the cooldown
             probe re-opens it, a healthy probe closes it.
  admission  non-finite / degenerate inputs are refused typed at
             submit, counted, and never reach a batch.
  numerics_trip  a bf16 request whose certification is fault-tripped
             degrades to f32 — counted, stamped on the report, and
             bitwise-equal to the solo f32 fit (a certified one equals
             the solo bf16 fit).
  disarmed   all faults disarmed: served results bitwise-equal solo
             fits and every resilience counter is zero.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import faults
from repro_torch.api import FastVAT, InvalidInput
from repro_torch.kernels import _build
from repro_torch.numerics import NumericsPolicy
from repro_torch.serve import (BreakerConfig, ExecutionError,
                               ResilienceStats, RetryPolicy, ServeConfig,
                               TendencyServer)

#: The result fields a served result must share bit for bit with its solo
#: fit (None on both, or equal tensors).
FIELDS = ("order", "rstar", "ivat_image", "sample_idx", "extension_labels",
          "group_sizes")


class _VirtualClock:
    """Monotonic clock the scenarios advance by hand (no real waits)."""

    def __init__(self):
        self._t = 0.0

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += dt


def _blobs(n: int, d: int = 3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    half = n // 2
    return np.concatenate([
        rng.normal(size=(half, d)),
        rng.normal(size=(n - half, d)) + 6.0]).astype(np.float32)


def _server(clock, device, **cfg) -> TendencyServer:
    cfg.setdefault("window_s", 999.0)     # flushes come from max_batch
    cfg.setdefault("retry", RetryPolicy(max_attempts=2, jitter=0.0))
    return TendencyServer(ServeConfig(device=device, **cfg), clock=clock,
                          sleep=lambda s: None)


def _solo(X: np.ndarray, method: str, device, **kw):
    return FastVAT(method=method, device=device, **kw).fit(X).result


def _same(a, b) -> bool:
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if (va is None) != (vb is None):
            return False
        if va is not None and not torch.equal(va, vb):
            return False
    return True


def _expect(problems: list, what: str, got, want) -> None:
    if got != want:
        problems.append(f"{what}: expected {want!r}, got {got!r}")


# ---------------------------------------------------------- scenarios ----

def scenario_poison(problems: list, device: str) -> None:
    srv = _server(_VirtualClock(), device, max_batch=4)
    try:
        faults.arm("serve.execute", times=-1,
                   match=lambda ctx: "poison" in ctx.get("tags", ()))
        data = {tag: _blobs(48, seed=i)
                for i, tag in enumerate(("a", "b", "poison", "c"))}
        futs = {tag: srv.submit(X, method="vat", tag=tag)
                for tag, X in data.items()}       # 4th submit flushes
        for tag in ("a", "b", "c"):
            served = futs[tag].result(timeout=300)
            if not _same(served, _solo(data[tag], "vat", device)):
                problems.append(f"survivor {tag!r} diverged from solo fit")
        try:
            futs["poison"].result(timeout=300)
            problems.append("poison lane produced a result; expected "
                            "ExecutionError")
        except ExecutionError as exc:
            if not isinstance(exc.__cause__, faults.FaultInjected):
                problems.append(f"poison cause: {exc.__cause__!r}")
        _expect(problems, "poison counters", srv.stats().resilience,
                ResilienceStats(splits=1, retries=2, failed=1))
    finally:
        srv.close()
        faults.disarm_all()


def scenario_fallback(problems: list, device: str) -> None:
    srv = _server(_VirtualClock(), device, max_batch=1)
    try:
        # the persistent kernel's program fails to build: the stepwise
        # kernel's serves, with the persistent fit's bits
        faults.arm("serve.build", times=-1,
                   match=lambda ctx: ctx.get("rung") in ("flashvat", "ivat")
                   and ctx["key"].turbo is not False)
        cuda = torch.device(device).type == "cuda"
        Xf = _blobs(50_000, d=64) if cuda else _blobs(48)
        _build.reset_launch_counts()
        served = srv.submit(Xf, method="flashvat").result(timeout=300)
        launches = _build.launch_counts()
        _expect(problems, "flashvat fallback engine",
                served.meta.method, "flashvat")
        if not _same(served, _solo(Xf, "flashvat", device, turbo=False)):
            problems.append("flashvat fallback diverged from the solo "
                            "stepwise fit")
        if not _same(served, _solo(Xf, "flashvat", device)):
            problems.append("flashvat fallback diverged from the solo "
                            "persistent fit")
        if cuda:       # one traversal: a step kernel launch a Prim step
            _expect(problems, "fallback persistent launches",
                    launches["prim_persist"], 0)
            _expect(problems, "fallback stepwise launches",
                    launches["prim_stream_step_batch"], len(Xf) - 1)
        # an ivat primary steps down one rung
        X = _blobs(48)
        served = srv.submit(X, method="ivat").result(timeout=300)
        _expect(problems, "fallback rung", served.meta.method, "vat")
        if not _same(served, _solo(X, "vat", device)):
            problems.append("fallback result diverged from solo vat fit")
        _expect(problems, "fallback counters", srv.stats().resilience,
                ResilienceStats(fallbacks=2, retries=2, degraded=2))
    finally:
        srv.close()
        faults.disarm_all()


def scenario_breaker(problems: list, device: str) -> None:
    clock = _VirtualClock()
    srv = _server(clock, device, max_batch=1,
                  retry=RetryPolicy(max_attempts=1),
                  breaker=BreakerConfig(threshold=2, cooldown_s=10.0))
    try:
        faults.arm("serve.build", times=-1,
                   match=lambda ctx: ctx.get("rung") == "ivat")
        X = _blobs(48)
        for _ in range(2):                        # trip: 2 primary fails
            srv.submit(X, method="ivat").result(timeout=300)
        _expect(problems, "tripped state",
                srv.breaker_state(48, 3, method="ivat"), "OPEN")
        built = faults.stats()["serve.build"]["fired"]
        srv.submit(X, method="ivat").result(timeout=300)  # pinned
        _expect(problems, "pinned primary attempts",
                faults.stats()["serve.build"]["fired"], built)
        clock.advance(10.0)
        srv.submit(X, method="ivat").result(timeout=300)  # probe, fails
        _expect(problems, "re-opened state",
                srv.breaker_state(48, 3, method="ivat"), "OPEN")
        faults.disarm("serve.build")              # "deploy the fix"
        clock.advance(10.0)
        served = srv.submit(X, method="ivat").result(timeout=300)
        _expect(problems, "recovered rung", served.meta.method, "ivat")
        if not _same(served, _solo(X, "ivat", device)):
            problems.append("recovered ivat result diverged from solo fit")
        _expect(problems, "recovered state",
                srv.breaker_state(48, 3, method="ivat"), "CLOSED")
        _expect(problems, "breaker counters", srv.stats().resilience,
                ResilienceStats(fallbacks=4, degraded=4, breaker_opens=2,
                                breaker_probes=2))
    finally:
        srv.close()
        faults.disarm_all()


def scenario_admission(problems: list, device: str) -> None:
    srv = _server(_VirtualClock(), device, max_batch=1)
    try:
        bad = _blobs(32)
        bad[0, 0] = np.nan
        for X, reason in ((bad, "non_finite"),
                          (np.ones((16, 3), np.float32), "degenerate")):
            try:
                srv.submit(X)
                problems.append(f"{reason} input was admitted")
            except InvalidInput as exc:
                _expect(problems, "admission reason", exc.reason, reason)
        _expect(problems, "admission counters", srv.stats().resilience,
                ResilienceStats(invalid_rejects=2))
    finally:
        srv.close()


def scenario_numerics_trip(problems: list, device: str) -> None:
    bf16 = NumericsPolicy(dtype="bf16")
    srv = _server(_VirtualClock(), device, max_batch=1, numerics=bf16)
    try:
        offset = np.float32(1.0e4)          # conditions; then bf16-safe
        X0 = _blobs(48) + offset
        clean = srv.submit(X0, method="vat").result(timeout=300)
        _expect(problems, "certified dtype",
                clean.meta.numerics.dtype, "bf16")
        _expect(problems, "certified fallbacks",
                clean.meta.numerics.fallbacks, 0)
        # the lane was packed as f32 values bf16 represents exactly: the
        # solo bf16 fit's bits
        if not _same(clean, _solo(X0, "vat", device, numerics=bf16)):
            problems.append("certified bf16 result diverged from the solo "
                            "bf16 fit")
        faults.arm("kernels.numerics_trip", times=1)
        X = _blobs(48, seed=1) + offset
        tripped = srv.submit(X, method="vat").result(timeout=300)
        rep = tripped.meta.numerics
        _expect(problems, "tripped dtype", rep.dtype, "f32")
        _expect(problems, "tripped fallbacks", rep.fallbacks, 1)
        _expect(problems, "tripped form", rep.form, "direct")
        # the degradation lands on the default f32 path: bitwise-equal
        # to the solo auto-policy fit of the same data
        if not _same(tripped, _solo(X, "vat", device)):
            problems.append("tripped bf16 result diverged from solo "
                            "f32 fit")
        _expect(problems, "numerics counters", srv.stats().resilience,
                ResilienceStats(numerics_fallbacks=1))
    finally:
        srv.close()
        faults.disarm_all()


def scenario_disarmed(problems: list, device: str) -> None:
    _expect(problems, "armed faults before disarmed run",
            faults.armed(), {})
    srv = _server(_VirtualClock(), device, max_batch=1)
    try:
        X = _blobs(48)
        for method in ("vat", "ivat", "flashvat"):
            served = srv.submit(X, method=method).result(timeout=300)
            if not _same(served, _solo(X, method, device)):
                problems.append(f"disarmed served {method} result "
                                "diverged from solo fit")
        _expect(problems, "disarmed counters", srv.stats().resilience,
                ResilienceStats())
    finally:
        srv.close()


SCENARIOS = {
    "poison": scenario_poison,
    "fallback": scenario_fallback,
    "breaker": scenario_breaker,
    "admission": scenario_admission,
    "numerics_trip": scenario_numerics_trip,
    "disarmed": scenario_disarmed,
}


def run(names, device: str = "cuda", out=print) -> int:
    """Run the named scenarios on ``device``; print one PASS/FAIL line
    each (through ``out``) and the problems of each failure on stderr.
    Returns the count of failed scenarios (a fault left armed counts as
    one)."""
    failed = 0
    for name in names:
        problems: list[str] = []
        SCENARIOS[name](problems, device)
        status = "PASS" if not problems else "FAIL"
        out(f"chaos/{name:<10s} {status}")
        for p in problems:
            print(f"    {p}", file=sys.stderr)
        failed += bool(problems)
    leftover = faults.armed()
    if leftover:
        print(f"chaos: faults left armed after run: {sorted(leftover)}",
              file=sys.stderr)
        faults.disarm_all()
        failed += 1
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="scripted fault schedules against the serving layer")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS),
                    help=f"comma-separated subset of {tuple(SCENARIOS)}")
    ap.add_argument("--device", default="cuda",
                    help="where the server runs: cuda (the CUDA kernels, "
                         "default) or cpu (their plain PyTorch versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for CI symmetry; the schedules are "
                         "already CI-sized")
    args = ap.parse_args(argv)

    names = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    if unknown := set(names) - set(SCENARIOS):
        ap.error(f"unknown scenarios {sorted(unknown)}; choose from "
                 f"{tuple(SCENARIOS)}")
    failed = run(names, args.device)
    print(f"chaos: {len(names) - failed}/{len(names)} scenarios clean")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

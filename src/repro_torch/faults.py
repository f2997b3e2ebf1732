"""Deterministic fault-injection registry, the port's own copy.

The same registry as ``repro/faults.py`` (numpy and the standard library
only), with its own state: arming ``repro.faults`` does not arm the port,
nor the other way round.  Every brittle seam carries a *named injection
site*, a ``fault_point(site, ...)`` call at the host-level boundary where a
real failure would surface.  Every site of the reference is live in the
port, under the reference's name: ``kernels.dispatch`` at the top of every
public wrapper of ``kernels/ops.py`` (context ``{"op", "use_pallas",
"device"}``; ``use_pallas`` is True when the call goes to a CUDA kernel,
so a ``match`` predicate written for the reference works here),
``kernels.numerics_trip`` at the bf16 certification of
``numerics/condition.py::resolve``, ``serve.build`` and ``serve.execute``
in ``serve/server.py``, ``history.deserialize`` in
``monitor/history.py``, and ``ckpt.aux_write`` and ``ckpt.aux_read`` at
the sidecars of ``checkpoint/ckpt.py``.
Tests *arm* deterministic faults against those sites; production code never
arms anything, and a disarmed site costs one module-dict truthiness check
(the ``if not _ARMED: return`` fast path): no lock, no allocation.

The port runs eagerly, so ``kernels.dispatch`` fires on every wrapper call
(the reference's fires when its wrapper is traced).

Scheduling is deterministic: a fault fires on hit numbers
``after <= hit < after + times`` (``times=-1`` = forever), optionally
gated by a ``match`` predicate over the site's context dict, and any
randomness (corruption byte choice) derives from the fault's ``seed``.
Two runs with the same arm calls see byte-identical fault behavior.

Kinds:

  raise     raise ``exc(message)`` (default :class:`FaultInjected`).
  delay     invoke the caller-provided ``sleep`` with ``delay_s``
            (a caller can pass an injectable sleep, so virtual-clock
            tests observe the delay without real wall time).
  corrupt   flip one deterministic byte of the site's payload —
            ``bytes``, ``np.ndarray``, a flat dict of arrays, or a file
            path (flipped in place).
  truncate  drop the tail of the payload (same payload types; files
            are truncated in place).

>>> import repro_torch.faults as faults
>>> with faults.injected("serve.execute", times=1):
...     try:
...         faults.fault_point("serve.execute")
...     except faults.FaultInjected as e:
...         print("fired:", e.site)
...     faults.fault_point("serve.execute")   # times=1 => second hit clean
fired: serve.execute
>>> faults.armed()
{}
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np

#: The registered injection sites, the reference's names — ``arm`` rejects
#: unknown names so a typo'd site can never silently arm nothing.
SITES = (
    "kernels.dispatch",     # kernels/ops.py public wrappers (every call)
    "serve.build",          # serve/server.py::_build_program
    "serve.execute",        # serve/server.py::_execute program run
    "ckpt.aux_write",       # checkpoint/ckpt.py sidecar file just written
    "ckpt.aux_read",        # checkpoint/ckpt.py::load_aux before reading
    "history.deserialize",  # monitor/history.py::TendencyHistory arrays
    "kernels.numerics_trip",  # numerics/condition.py::resolve bf16 cert
)


class FaultInjected(RuntimeError):
    """The default exception an armed ``raise`` fault throws.

    ``site`` names the injection point, so handlers and tests can tell
    injected failures from organic ones.
    """

    def __init__(self, site: str, message: str = ""):
        self.site = site
        super().__init__(message or f"injected fault at site {site!r}")


@dataclasses.dataclass
class Fault:
    """One armed fault (see module docstring for the kind semantics).

    Attributes:
      site: the injection site this fault is bound to.
      kind: "raise" | "delay" | "corrupt" | "truncate".
      times: firings before the fault stops matching (-1 = forever).
      after: hits skipped before the first firing (count scheduling).
      exc: exception type for kind="raise" (constructed as
        ``exc(site, message)`` for FaultInjected subclasses, else
        ``exc(message)``).
      message: exception text override.
      delay_s: sleep length for kind="delay".
      seed: determinism source for corruption byte choices.
      match: optional predicate over the site's context dict — the hit
        does not count (and the fault does not fire) unless it returns
        True.  This is how a test poisons exactly one lane of a batch.
      hits: matched-context visits so far (telemetry).
      fired: actual firings so far (telemetry).
    """

    site: str
    kind: str = "raise"
    times: int = 1
    after: int = 0
    exc: type[BaseException] = FaultInjected
    message: str = ""
    delay_s: float = 0.0
    seed: int = 0
    match: Callable[[dict], bool] | None = None
    hits: int = 0
    fired: int = 0

    def _should_fire(self) -> bool:
        i = self.hits  # 0-based index of the *current* hit
        if i < self.after:
            return False
        return self.times < 0 or i < self.after + self.times


_ARMED: dict[str, Fault] = {}
_LOCK = threading.Lock()
_KINDS = ("raise", "delay", "corrupt", "truncate")


def arm(site: str, *, kind: str = "raise", times: int = 1, after: int = 0,
        exc: type[BaseException] = FaultInjected, message: str = "",
        delay_s: float = 0.0, seed: int = 0,
        match: Callable[[dict], bool] | None = None) -> Fault:
    """Arm one fault at a registered site (replacing any existing one)."""
    if site not in SITES:
        raise ValueError(f"unknown injection site {site!r}; registered "
                         f"sites: {list(SITES)}")
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    fault = Fault(site=site, kind=kind, times=times, after=after, exc=exc,
                  message=message, delay_s=delay_s, seed=seed, match=match)
    with _LOCK:
        _ARMED[site] = fault
    return fault


def disarm(site: str) -> None:
    """Remove the fault at ``site`` (no-op when nothing is armed)."""
    with _LOCK:
        _ARMED.pop(site, None)


def disarm_all() -> None:
    """Remove every armed fault (test teardown)."""
    with _LOCK:
        _ARMED.clear()


def is_armed(site: str) -> bool:
    return site in _ARMED


def armed() -> dict[str, Fault]:
    """Snapshot copy of the armed-fault map."""
    with _LOCK:
        return dict(_ARMED)


def stats() -> dict[str, dict[str, int]]:
    """Per-site {hits, fired} telemetry for the armed faults."""
    with _LOCK:
        return {s: {"hits": f.hits, "fired": f.fired}
                for s, f in _ARMED.items()}


@contextlib.contextmanager
def injected(site: str, **kw):
    """``arm`` for the duration of a with-block, then disarm the site."""
    fault = arm(site, **kw)
    try:
        yield fault
    finally:
        disarm(site)


# --------------------------------------------------------- the hook ----

def fault_point(site: str, *, context: dict | None = None,
                data: Any = None, path: str | None = None,
                sleep: Callable[[float], None] | None = None) -> Any:
    """The injection hook production code calls at each named site.

    Disarmed (the production state) this returns ``data`` after a
    single dict truthiness check.  Armed, it applies the fault's kind:
    raising, delaying via ``sleep``, or returning/overwriting a
    corrupted payload (``data`` or the file at ``path``).

    Args:
      site: registered site name.
      context: site-specific facts the fault's ``match`` predicate can
        inspect (e.g. ``{"tags": [...], "key": ProgramKey}``).
      data: payload for corrupt/truncate kinds (bytes / ndarray / flat
        dict of arrays); returned unchanged for other kinds.
      path: file path for corrupt/truncate kinds that mutate a file.
      sleep: sleeper for delay kind; defaults to ``time.sleep``.

    Returns:
      ``data`` (possibly corrupted/truncated).
    """
    if not _ARMED:           # the zero-overhead disarmed fast path
        return data
    with _LOCK:
        fault = _ARMED.get(site)
        if fault is None:
            return data
        if fault.match is not None and not fault.match(context or {}):
            return data
        fire = fault._should_fire()
        fault.hits += 1
        if fire:
            fault.fired += 1
    if not fire:
        return data
    if fault.kind == "raise":
        if issubclass(fault.exc, FaultInjected):
            raise fault.exc(site, fault.message)
        raise fault.exc(fault.message or
                        f"injected fault at site {site!r}")
    if fault.kind == "delay":
        (sleep if sleep is not None else time.sleep)(fault.delay_s)
        return data
    if path is not None:
        _mutate_file(path, fault)
        return data
    return _mutate_payload(data, fault)


# ---------------------------------------------------- corruption ops ----

def _flip_index(length: int, seed: int) -> int:
    """Deterministic byte offset to flip — away from both ends so zip /
    npz magic headers survive and the corruption lands in array data."""
    if length <= 2:
        return 0
    rng = np.random.default_rng(np.random.SeedSequence([seed, length]))
    return int(rng.integers(low=length // 4, high=max(length // 4 + 1,
                                                      3 * length // 4)))


def _mutate_file(fpath: str, fault: Fault) -> None:
    with open(fpath, "rb") as f:
        raw = bytearray(f.read())
    if fault.kind == "truncate":
        raw = raw[: max(1, len(raw) // 2)]
    else:
        i = _flip_index(len(raw), fault.seed)
        raw[i] ^= 0xFF
    with open(fpath, "wb") as f:
        f.write(bytes(raw))


def _mutate_payload(data: Any, fault: Fault) -> Any:
    if data is None:
        return None
    if isinstance(data, (bytes, bytearray)):
        raw = bytearray(data)
        if fault.kind == "truncate":
            return bytes(raw[: max(1, len(raw) // 2)])
        i = _flip_index(len(raw), fault.seed)
        raw[i] ^= 0xFF
        return bytes(raw)
    if isinstance(data, np.ndarray):
        return _mutate_array(data, fault)
    if isinstance(data, dict):
        # flat dict of arrays (the history sidecar shape): corrupt one
        # value, chosen deterministically by seed.
        out = dict(data)
        keys = sorted(k for k, v in out.items()
                      if isinstance(v, np.ndarray) and v.nbytes > 0)
        if not keys:
            return out
        k = keys[fault.seed % len(keys)]
        out[k] = _mutate_array(np.asarray(out[k]), fault)
        return out
    raise TypeError(f"fault_point cannot corrupt payload of type "
                    f"{type(data).__name__}")


def _mutate_array(arr: np.ndarray, fault: Fault) -> np.ndarray:
    arr = np.array(arr, copy=True)
    if fault.kind == "truncate":
        flat = arr.reshape(-1)
        return flat[: max(1, flat.shape[0] // 2)]
    view = arr.view(np.uint8).reshape(-1)
    if view.size:
        view[_flip_index(view.size, fault.seed)] ^= 0xFF
    return arr

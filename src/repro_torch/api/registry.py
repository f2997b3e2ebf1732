"""The rung registry: method names -> fitters + capability flags.

``FastVAT`` is data-driven dispatch over this table, as in
``repro/api/registry.py``.  Each ``Rung`` entry owns its fitter (an
adapter that runs a ``repro_torch.core`` rung and wraps its output into
the uniform ``TendencyResult``), its capability flags and its
auto-selection threshold.

The port registers the ``vat`` and ``ivat`` rungs.  The reference's other
rungs are listed in ``UNPORTED`` with their auto-selection thresholds, so
``select_method`` still picks what the reference would pick — and
``FastVAT.fit`` raises ``NotImplementedError`` naming that rung instead of
quietly running ``vat`` at a size the reference hands elsewhere.

>>> from repro_torch.api import registry
>>> sorted(registry.registered())
['ivat', 'vat']
>>> registry.select_method(100), registry.select_method(10_000)
('vat', 'flashvat')
>>> registry.select_method(1_000_000, precomputed=True)   # matrix exists
'vat'
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

from repro_torch import core
from repro_torch.api.result import ResultMeta, TendencyResult

#: Auto-selection thresholds, the reference's: materialized exact VAT up to
#: SMALL_N, matrix-free exact VAT (flashvat) to MEDIUM_N, the kNN-graph
#: approximation (approx) beyond.
SMALL_N = 2_048
MEDIUM_N = 50_000

#: Rungs of the reference the port does not have yet -> their
#: auto-selection threshold (None: opt-in only).  None of them accepts
#: precomputed input.
UNPORTED = {"flashvat": MEDIUM_N, "approx": math.inf, "svat": None,
            "bigvat": None, "dvat": None, "embed": None}


class RungOptions(NamedTuple):
    """Facade knobs forwarded to a fitter (metric/seed/device ride on
    ``ResultMeta``).

    ``num_form`` is the numerics shield's tile-form plan: "gram" (default
    — the ‖x‖²+‖y‖²−2x·y form) or "direct" (per-coordinate (x−y)², no
    cancellation).  The facade sets it from ``numerics.resolve``.
    """
    num_form: str = "gram"


Fitter = Callable[[Any, ResultMeta, RungOptions], TendencyResult]


@dataclasses.dataclass(frozen=True)
class Rung:
    """One registered VAT method.

    Attributes:
      name: the ``method=`` string.
      fit: solo fitter — (X_or_D tensor on the fit's device, meta,
        options) -> TendencyResult.
      supports_precomputed: accepts metric="precomputed" input.
      auto_threshold: largest n ``select_method`` hands this rung
        (math.inf = unbounded fallback); None = never auto-selected.
      description: one-liner for docs/tooling.
    """

    name: str
    fit: Fitter
    supports_precomputed: bool = False
    auto_threshold: float | None = None
    description: str = ""


_REGISTRY: dict[str, Rung] = {}


def register(rung: Rung, *, overwrite: bool = False) -> Rung:
    """Add a rung; its name becomes a valid ``FastVAT(method=...)``."""
    if rung.name == "auto" or not rung.name:
        raise ValueError(f"invalid rung name {rung.name!r}")
    if rung.name in _REGISTRY and not overwrite:
        raise ValueError(f"rung {rung.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[rung.name] = rung
    return rung


def not_ported(name: str, n: int | None = None) -> NotImplementedError:
    """The error for a rung the reference has and the port does not yet."""
    at = "" if n is None else f" (the reference's choice for n={n})"
    return NotImplementedError(
        f"rung {name!r}{at} is not ported to repro_torch yet; ported rungs: "
        f"{registered()}")


def get_rung(name: str) -> Rung:
    """Look up a registered rung by method name."""
    if name in UNPORTED:
        raise not_ported(name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown method {name!r}; registered: "
                       f"{registered()}") from None


def registered() -> tuple[str, ...]:
    """Names of every registered rung."""
    return tuple(_REGISTRY)


def methods() -> tuple[str, ...]:
    """Everything ``FastVAT(method=...)`` accepts: "auto" + the rungs."""
    return ("auto",) + registered()


def select_method(n: int, *, precomputed: bool = False,
                  strict: bool = False) -> str:
    """The auto-selection policy, data-driven over rung capabilities.

    The candidates are the registered rungs and the ``UNPORTED`` ones, so
    the choice is the reference's; the caller raises when it falls on an
    unported rung.

    Args:
      n: points per dataset.
      precomputed: restrict to rungs accepting metric="precomputed".
      strict: raise LookupError when no candidate's threshold covers n
        instead of falling back to the largest-threshold candidate (the
        fallback serves precomputed input, where the O(n^2) matrix
        already exists so the exact rung stays the right answer).

    Returns:
      The selected method name.
    """
    cands = [(r.auto_threshold, r.name) for r in _REGISTRY.values()
             if r.auto_threshold is not None
             and (r.supports_precomputed or not precomputed)]
    if not precomputed:
        cands += [(t, name) for name, t in UNPORTED.items() if t is not None]
    cands.sort()
    if not cands:
        raise LookupError(f"no auto-selectable rung matches "
                          f"(precomputed={precomputed})")
    for threshold, name in cands:
        if n <= threshold:
            return name
    if strict:
        raise LookupError(f"no auto-selectable rung covers n={n}")
    return cands[-1][1]


# ---------------------------------------------------------------------
# Built-in rung fitters: run a repro_torch.core rung, wrap the result.
# ---------------------------------------------------------------------

def _vat_result(data, meta: ResultMeta, opts: RungOptions) -> core.VATResult:
    if meta.metric == "precomputed":
        return core.vat_from_dist(data)
    return core.vat(data, metric=meta.metric, form=opts.num_form)


def _fit_vat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    res = _vat_result(data, meta, opts)
    return TendencyResult(order=res.order, rstar=res.rstar, ivat_image=None,
                          meta=meta)


def _fit_ivat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    res = _vat_result(data, meta, opts)
    iv = core.ivat_from_vat(res.rstar)
    return TendencyResult(order=res.order, rstar=res.rstar, ivat_image=iv,
                          meta=meta)


register(Rung(
    name="vat", fit=_fit_vat, supports_precomputed=True,
    auto_threshold=SMALL_N,
    description="exact VAT — O(n^2) matrix fits easily"))
register(Rung(
    name="ivat", fit=_fit_ivat, supports_precomputed=True,
    auto_threshold=None,
    description="exact VAT + geodesic (iVAT) image; opt-in"))

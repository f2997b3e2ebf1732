"""Conditioning pre-pass: scale diagnostics, κ, and the policy resolver.

The port's own copy of ``repro/numerics/condition.py``: host-side numpy,
ported verbatim; its bf16 certification carries the port's
``kernels.numerics_trip`` fault site (``repro_torch.faults``).

The fast engines buy speed with the Gram decomposition ``‖x‖² + ‖y‖² −
2 x·y``, whose cancellation error is ABSOLUTE — up to ``C·eps·max‖x‖²``
regardless of how small the distance being computed is.  On centered
O(1) data that error is ulps; on data offset 1e4 from the origin it is
larger than typical inter-point gaps and silently reorders near-ties.
This module decides, per fit and on the host (before any kernel is
launched), three things:

  1. **How bad is it?**  ``condition_stats`` streams a cheap pre-pass
     over X: max‖x‖², the coordinate spread, a pairwise-gap proxy (the
     median nonzero squared distance over a deterministic strided
     subsample), and the condition estimate

         κ = max‖x‖² / gap_proxy

     — the ratio of the Gram error's scale to the scale of the
     distances it perturbs.

  2. **What to run.**  ``resolve`` maps a ``NumericsPolicy`` to a
     concrete plan: the tile ``form`` ("gram" | "direct") every kernel
     takes statically, plus whether to apply the conditioning transform.
     ``auto`` (the default) keeps today's fast path byte-for-byte while
     κ ≤ ``KAPPA_SAFE`` and switches to direct-form tiles on
     conditioned data beyond it.

  3. **The transform.**  ``condition_transform`` mean-centers in f64 and
     rescales by a power of two before casting back to f32.  Both pieces
     are ordering-isometries of the translation-invariant metrics
     (euclidean / sqeuclidean / manhattan): centering is an exact
     translation, and a power-of-2 rescale commutes BITWISE through the
     whole distance computation (multiplying every coordinate by 2^k is
     exact in binary floating point; squared distances scale by the
     exact factor 2^2k and euclidean distances by 2^k, so every min /
     argmin / tie compares identically).  Cosine and precomputed input
     are left untouched (centering is not an isometry of cosine).

Derivation of ``KAPPA_SAFE`` (why 8192): the engines' Gram rows carry
absolute error bounded in practice by ``64·eps·max‖x‖²`` (the same
64-ulp allowance the Turbo pruning bound debits — see
``lb_slack_ulps``).  An ordering can only flip when that error spans a
real inter-point gap; demanding the error stay below ``gap/16`` gives

    64·eps·max_sq ≤ gap/16   ⇔   κ = max_sq/gap ≤ 1/(1024·eps) = 8192.

The threshold is deliberately a power of two and deliberately
conservative by the 16× guard factor: below it the Gram path is
certifiably order-safe, above it ``auto`` pays the ~2× direct-form cost.

bf16 storage (``NumericsPolicy.dtype="bf16"``) is certified the same
way BEFORE fitting: bf16's eps is 2^-8, so quantizing the conditioned
coordinates perturbs squared distances by up to ``~4·eps_bf16·max_sq``
relative to the post-transform scale; requiring that below ``gap/4``
gives ``KAPPA_BF16 = 16``.  A fit whose conditioned κ exceeds it falls
back to f32 — a counted degradation (``NumericsReport.fallbacks``) with
the ``kernels.numerics_trip`` fault site at the decision.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import faults

#: Largest condition estimate at which the Gram-form tiles are
#: certifiably order-safe (see module docstring for the derivation:
#: 64·eps·max_sq ≤ gap/16  ⇔  κ ≤ 1/(1024·eps_f32) = 8192).
KAPPA_SAFE = 8192.0

#: Largest CONDITIONED condition estimate at which bf16 coordinate
#: storage passes certification (4·eps_bf16·max_sq ≤ gap/4 with
#: eps_bf16 = 2^-8  ⇔  κ ≤ 16).
KAPPA_BF16 = 16.0

#: Metrics the conditioning transform is an ordering-isometry of.
#: Cosine is scale- but not translation-invariant; "precomputed" never
#: reaches the kernels as points at all.
CONDITIONED_METRICS = ("euclidean", "sqeuclidean", "manhattan")

#: Rows the gap-proxy subsample is capped at — the pre-pass must stay
#: O(n·d + s²) with s tiny next to any fit.
_GAP_SAMPLE = 256

_F32_EPS = float(np.finfo(np.float32).eps)

_MODES = ("fast", "safe", "auto")
_DTYPES = ("f32", "bf16")
_FORMS = ("gram", "direct")


def lb_slack_ulps(form: str) -> float:
    """Per-form ulp allowance for absolute row error at scale max‖x‖².

    The shared constant behind two consumers: the Turbo engine's lazy
    pruning bound debits ``lb_slack_ulps(form)·eps·max‖x‖²`` (squared
    units) from every tile lower bound, and ``KAPPA_SAFE`` above is
    derived from the gram value.

      * "gram"   -> 64.0 — the aux + aux_q − 2·cross decomposition sums
        three terms of magnitude max‖x‖²; 64 ulps covers their combined
        rounding + cancellation with >10× headroom (the Turbo engine's
        original constant, unchanged so every prune pin stays bitwise).
      * "direct" -> 4.0 — the (x−y)² form has no cancellation: its
        error is RELATIVE to the computed distance, the multiplicative
        ``_LB_MARGIN`` already covers that, and the tiny absolute
        allowance only guards the final sum's rounding at full scale.
    """
    check_form(form)
    return 64.0 if form == "gram" else 4.0


def check_form(form: str) -> None:
    if form not in _FORMS:
        raise ValueError(f"form must be one of {_FORMS}, got {form!r}")


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """What the caller ASKS for (``FastVAT(numerics=...)``); ``resolve``
    turns it into a plan.

    Attributes:
      mode: "fast" — always Gram-form tiles on the data as given
        (byte-for-byte the pre-shield behavior); "safe" — always
        direct-form tiles on conditioned data; "auto" (default) —
        fast while κ ≤ ``KAPPA_SAFE``, safe beyond.
      dtype: coordinate storage — "f32" (default) or "bf16" (quantize
        the conditioned coordinates to bf16 precision; accumulation
        stays f32 everywhere).  bf16 is certified per fit and falls
        back to f32 when the certification bound fails.
    """

    mode: str = "auto"
    dtype: str = "f32"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"numerics mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"numerics dtype must be one of {_DTYPES}, "
                             f"got {self.dtype!r}")


def as_policy(numerics) -> NumericsPolicy:
    """Coerce the facade knob: a policy passes through, a string is a
    mode shorthand ("auto" == NumericsPolicy(mode="auto"))."""
    if isinstance(numerics, NumericsPolicy):
        return numerics
    if isinstance(numerics, str):
        return NumericsPolicy(mode=numerics)
    raise TypeError("numerics must be a NumericsPolicy or a mode string "
                    f"('fast' | 'safe' | 'auto'), got {numerics!r}")


@dataclasses.dataclass(frozen=True)
class NumericsReport:
    """What a fit ACTUALLY ran — stamped on ``ResultMeta.numerics``.

    Frozen and hashable, like ``ResultMeta`` that carries it.

    Attributes:
      kappa: the pre-transform condition estimate (worst lane for a
        batched fit).
      mode: the requested policy mode.
      form: tile form the kernels ran ("gram" | "direct").
      dtype: coordinate storage the fit actually used ("f32" | "bf16" —
        f32 after a bf16 certification fallback).
      conditioned: whether the mean-center + power-of-2 rescale was
        applied before kernel entry.
      fallbacks: counted degradations (currently: 1 when bf16 was
        requested but failed certification or was fault-tripped).
    """

    kappa: float
    mode: str
    form: str
    dtype: str
    conditioned: bool
    fallbacks: int = 0


@dataclasses.dataclass(frozen=True)
class ConditionStats:
    """The pre-pass scale statistics (all f64, computed on the host).

    Attributes:
      max_sq_norm: max‖x‖² of the data as given — the Gram error scale.
      centered_max_sq: max‖x − mean‖² — the error scale conditioning
        would leave.
      spread: max over dims of (max − min) coordinate extent.
      gap_proxy: median nonzero squared euclidean distance over the
        strided subsample — the scale an ordering flip must span.
      kappa: max_sq_norm / gap_proxy (∞ when the proxy is 0).
      kappa_centered: centered_max_sq / gap_proxy — what κ becomes
        after conditioning (the bf16 certification input).
    """

    max_sq_norm: float
    centered_max_sq: float
    spread: float
    gap_proxy: float
    kappa: float
    kappa_centered: float


def _stats_one(X: np.ndarray) -> ConditionStats:
    Xd = np.asarray(X, np.float64)
    sq = np.einsum("nd,nd->n", Xd, Xd)
    max_sq = float(np.max(sq)) if sq.size else 0.0
    mean = np.mean(Xd, axis=0)
    C = Xd - mean
    csq = np.einsum("nd,nd->n", C, C)
    centered_max_sq = float(np.max(csq)) if csq.size else 0.0
    spread = float(np.max(np.ptp(Xd, axis=0))) if Xd.size else 0.0
    n = Xd.shape[0]
    stride = max(1, n // _GAP_SAMPLE)
    S = Xd[::stride][:_GAP_SAMPLE]
    ssq = np.einsum("nd,nd->n", S, S)
    G = ssq[:, None] + ssq[None, :] - 2.0 * (S @ S.T)
    np.maximum(G, 0.0, out=G)
    off = G[np.triu_indices(S.shape[0], k=1)]
    nz = off[off > 0.0]
    gap = float(np.median(nz)) if nz.size else 0.0
    kappa = max_sq / gap if gap > 0.0 else (0.0 if max_sq == 0.0
                                            else float("inf"))
    kc = centered_max_sq / gap if gap > 0.0 else (
        0.0 if centered_max_sq == 0.0 else float("inf"))
    return ConditionStats(max_sq_norm=max_sq,
                          centered_max_sq=centered_max_sq, spread=spread,
                          gap_proxy=gap, kappa=kappa, kappa_centered=kc)


def condition_stats(X) -> ConditionStats:
    """Scale statistics of an (n, d) matrix or (b, n, d) stack.

    κ is always measured on squared-euclidean geometry regardless of
    the metric the fit will run — the Gram decomposition whose error it
    bounds is the squared-euclidean one, and the manhattan/cosine tiles
    inherit the SAME coordinate-scale pathologies.  A batched stack
    reports the worst lane (max κ, max scales, min gap): conditioning
    is all-or-nothing per fit, so the plan must be safe for every lane.
    """
    arr = np.asarray(X, np.float64)
    if arr.ndim == 2:
        return _stats_one(arr)
    if arr.ndim != 3:
        raise ValueError(f"condition_stats wants (n, d) or (b, n, d), "
                         f"got shape {arr.shape}")
    per = [_stats_one(lane) for lane in arr]
    return ConditionStats(
        max_sq_norm=max(s.max_sq_norm for s in per),
        centered_max_sq=max(s.centered_max_sq for s in per),
        spread=max(s.spread for s in per),
        gap_proxy=min(s.gap_proxy for s in per),
        kappa=max(s.kappa for s in per),
        kappa_centered=max(s.kappa_centered for s in per))


def condition_transform(X) -> np.ndarray:
    """Mean-center (f64) + power-of-2 rescale; returns f32.

    Per dataset (batched stacks transform each lane independently):
    subtract the f64 column means, then multiply by ``2^-ceil`` where
    ``ceil = floor(log2(max |centered|))`` so coordinates land in
    [-2, 2).  The scale is a power of two, so the rescale is EXACT in
    binary floating point and commutes bitwise through every distance
    formula (see module docstring); the centering is where the actual
    conditioning happens — it removes the common offset that inflates
    ‖x‖² without moving any pairwise difference.

    The transform is a pure function of the centered coordinates:
    ``condition_transform(X + c·1) == condition_transform(X)`` bitwise
    whenever the f64 arithmetic of ``(X + c) − mean(X + c)`` is exact —
    which the shift-invariance pins arrange and real uncentered data
    matches to the last ulp of the f64 mean.
    """
    Xd = np.asarray(X, np.float64)
    mean = np.mean(Xd, axis=-2, keepdims=True)
    C = Xd - mean
    amax = np.max(np.abs(C), axis=(-2, -1), keepdims=True)
    # scale = 2^-floor(log2(amax)): exact powers of two, never 0/inf
    safe = np.where(amax > 0.0, amax, 1.0)
    scale = np.exp2(-np.floor(np.log2(safe)))
    return np.asarray(C * scale, np.float32)


def _quantize_bf16(X: np.ndarray) -> np.ndarray:
    """Round f32 coordinates to bf16 storage precision, back in f32.

    bf16 is f32 with the low 16 mantissa bits dropped; round-to-nearest
    -even on the retained bits matches what accelerator storage does.
    Keeping the result in an f32 container means every existing tile
    runs unchanged with f32 accumulation — this models the STORAGE
    precision (what the ROADMAP's accelerator rung will keep in HBM),
    not a compute downgrade.
    """
    u = np.ascontiguousarray(X, np.float32).view(np.uint32)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32).reshape(X.shape)


def resolve(X, *, metric: str, policy: NumericsPolicy | str | None = None,
            batched: bool = False):
    """The host pre-pass: turn (data, metric, policy) into a plan.

    Runs before anything is enqueued — the returned ``form`` and
    ``dtype`` are fixed by the time a kernel sees them.

    Args:
      X: (n, d) points, or a (b, n, d) stack with ``batched=True``.
      metric: the fit's metric; conditioning only applies to
        ``CONDITIONED_METRICS`` (cosine/precomputed pass through).
      policy: a ``NumericsPolicy``, a mode string, or None (defaults).
      batched: X carries a leading batch axis.

    Returns:
      (X_out (np.float32, same shape), NumericsReport) — ``X_out`` is
      X unchanged (fast mode / gram-auto; also any non-conditioned
      metric) or the conditioned (and possibly bf16-quantized) copy.
    """
    policy = as_policy(policy if policy is not None else NumericsPolicy())
    Xf = np.asarray(X, np.float32)
    if batched and Xf.ndim != 3:
        raise ValueError(f"resolve(batched=True) wants (b, n, d), got "
                         f"shape {Xf.shape}")
    conditionable = metric in CONDITIONED_METRICS
    stats = condition_stats(Xf)

    if policy.mode == "fast":
        condition = False
    elif policy.mode == "safe":
        condition = conditionable
    else:  # auto: today's path verbatim while the Gram bound holds
        condition = conditionable and stats.kappa > KAPPA_SAFE
    form = "direct" if condition else "gram"

    Xout = condition_transform(Xf) if condition else Xf

    dtype, fallbacks = "f32", 0
    if policy.dtype == "bf16":
        kappa_eff = stats.kappa_centered if condition else stats.kappa
        certified = conditionable and kappa_eff <= KAPPA_BF16
        try:
            faults.fault_point("kernels.numerics_trip",
                               context={"metric": metric, "mode": policy.mode,
                                        "kappa": kappa_eff,
                                        "certified": certified})
        except faults.FaultInjected:
            certified = False
        if certified:
            Xout = _quantize_bf16(Xout)
            dtype = "bf16"
        else:
            fallbacks = 1

    report = NumericsReport(kappa=stats.kappa, mode=policy.mode, form=form,
                            dtype=dtype, conditioned=condition,
                            fallbacks=fallbacks)
    return Xout, report

"""Adversarial certification harness, the port of
``repro/numerics/certify.py``.

The numerics shield makes a quantified promise: under the default
``auto`` policy a fit's ordering stays *spanning-tree-faithful* to the
f64 oracle geometry even on adversarially ill-conditioned input.  This
module is where that promise is checked, end to end, through the real
public surface (``FastVAT``, on the card by default) rather than against
kernel internals:

  1. **Generators** — deterministic worst-case datasets, each targeting
     one failure mode of the fast engines (huge common offsets, tiny
     gaps at scale, near-duplicate ties, mixed per-dimension scales,
     shell data maximizing ‖x‖² against gap).
  2. **Oracle** — f64 pairwise dissimilarities (numpy, no Gram trick:
     explicit differences) traversed by the pure-Python
     ``core.naive.vat_order_naive`` Prim — the repo's ground-truth VAT.
  3. **Quantification** — a fitted ordering is scored by its spanning
     -tree weight *measured in the f64 oracle geometry*: ``w(order) =
     Σ_i min_{j<i} R64[order[i], order[j]]``.  For the oracle ordering
     this is the exact MST weight; any mis-ordering caused by f32/bf16
     error shows up as relative excess weight.  Ordering equality is
     checked first (the common case on clean fits) but is NOT required
     — near-ties may legitimately resolve differently at different
     precisions without changing the tree weight materially.

Bounds: ``EXCESS_F32 = 1e-5`` for f32 fits, ``EXCESS_BF16 = 1e-2`` for
certified-bf16 fits (bf16 keeps 8 mantissa bits, so relative coordinate
perturbation ~2^-9 can move the tree weight by that order).  A bf16
request that FAILED certification ran at f32 (the counted fallback) and
is held to the f32 bound — degradation must not loosen the promise.

Run as a module::

    PYTHONPATH=src python -m repro_torch.numerics.certify [--smoke]
        [--device cpu]

which sweeps the rungs × policies × conditioned metrics over the
generators (on the card unless ``--device cpu``) and exits nonzero if any
cell breaks its bound.  Import-light callers note: this module pulls in
the API layer (FastVAT), so the ``repro_torch.numerics`` package root
deliberately does not import it.
"""
from __future__ import annotations

import argparse
import dataclasses
import zlib

import numpy as np

from repro_torch.core.naive import vat_order_naive
from repro_torch.numerics.condition import (CONDITIONED_METRICS,
                                            NumericsPolicy, as_policy)

#: Relative spanning-tree excess bounds per realized storage dtype.
EXCESS_F32 = 1e-5
EXCESS_BF16 = 1e-2

#: The approx rung carries a kNN-graph spanning defect that is a
#: property of the RUNG, not of numerics (measured and reported on
#: ``ResultMeta.approx``; it can be large in squared geometry, where a
#: missing cross-cluster edge's detour weight is amplified).  The shield
#: therefore certifies approx against its own best-numerics baseline:
#: ``sweep`` measures the safe-f32 excess per (generator, metric) once
#: and passes it as ``slack`` — a policy only fails if it adds error ON
#: TOP of the rung's intrinsic defect.


# ------------------------------------------------------------------
# Adversarial generators — pure functions of a seed, small n so the
# pure-Python oracle stays cheap.  Each returns (n, d) float32.
# ------------------------------------------------------------------

def _offset_clusters(rng: np.random.Generator, n: int = 64) -> np.ndarray:
    """Two unit clusters translated 1e4 from the origin: the canonical
    Gram catastrophe (max‖x‖² ~ 1e8 vs gaps ~ 1)."""
    half = n // 2
    a = rng.normal(size=(half, 4))
    b = rng.normal(size=(n - half, 4)) + 6.0
    return np.asarray(np.concatenate([a, b]) + 1.0e4, np.float32)


def _tiny_gaps(rng: np.random.Generator, n: int = 64) -> np.ndarray:
    """A jittered lattice with inter-point gaps ~1e-2 sitting at offset
    1e3 — the gaps are BELOW the Gram error scale there."""
    base = rng.permutation(n).astype(np.float64)[:, None] * 1e-2
    jitter = rng.normal(size=(n, 3)) * 1e-3
    X = np.concatenate([base, np.zeros((n, 2))], axis=1) + jitter
    return np.asarray(X + 1.0e3, np.float32)


def _near_duplicates(rng: np.random.Generator, n: int = 64) -> np.ndarray:
    """Pairs of near-identical points (separation 1e-3) at offset 1e4 —
    cancellation noise larger than the pair separations reorders the
    duplicate chains under the naive fast path."""
    half = n // 2
    base = rng.normal(size=(half, 4)) * 3.0
    dup = base + rng.normal(size=(half, 4)) * 1e-3
    return np.asarray(np.concatenate([base, dup]) + 1.0e4, np.float32)


def _mixed_scale(rng: np.random.Generator, n: int = 64) -> np.ndarray:
    """Per-dimension scales spanning six orders of magnitude, with the
    large dimensions carrying a common offset."""
    scales = np.array([1e-3, 1e-1, 1e1, 1e3])
    X = rng.normal(size=(n, 4)) * scales
    X[:, 3] += 1.0e4
    return np.asarray(X, np.float32)


def _shell(rng: np.random.Generator, n: int = 64) -> np.ndarray:
    """Points on a thin shell of radius 1e3: every ‖x‖² is maximal for
    the spread, so κ is large with NO mean offset to remove — the
    conditioning transform must still win via the gap-aware dispatch."""
    V = rng.normal(size=(n, 4))
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    R = 1.0e3 * (1.0 + rng.normal(size=(n, 1)) * 1e-4)
    return np.asarray(V * R, np.float32)


GENERATORS = {
    "offset_clusters": _offset_clusters,
    "tiny_gaps": _tiny_gaps,
    "near_duplicates": _near_duplicates,
    "mixed_scale": _mixed_scale,
    "shell": _shell,
}


# ------------------------------------------------------------------
# f64 oracle
# ------------------------------------------------------------------

def oracle_dissim(X, metric: str) -> np.ndarray:
    """f64 pairwise dissimilarity by explicit differences (no Gram)."""
    Xd = np.asarray(X, np.float64)
    if metric in ("euclidean", "sqeuclidean"):
        diff = Xd[:, None, :] - Xd[None, :, :]
        sq = np.einsum("ijd,ijd->ij", diff, diff)
        return np.sqrt(sq) if metric == "euclidean" else sq
    if metric == "manhattan":
        return np.abs(Xd[:, None, :] - Xd[None, :, :]).sum(axis=-1)
    if metric == "cosine":
        norms = np.sqrt(np.einsum("nd,nd->n", Xd, Xd))
        denom = np.maximum(norms[:, None] * norms[None, :], 1e-300)
        return np.clip(1.0 - (Xd @ Xd.T) / denom, 0.0, 2.0)
    raise ValueError(f"no f64 oracle for metric {metric!r}")


def tree_weight(R64: np.ndarray, order) -> float:
    """Spanning-tree weight of an ordering in the oracle geometry."""
    order = np.asarray(order)
    w = 0.0
    for i in range(1, len(order)):
        w += float(np.min(R64[order[i], order[:i]]))
    return w


def ordering_excess(X, order, metric: str) -> tuple[float, bool]:
    """(relative excess tree weight vs the f64 oracle, exact-equality).

    Exactness means the fitted ordering IS the oracle Prim traversal;
    excess 0.0 with exact=False means a different-but-equally-minimal
    traversal (legitimate tie resolution).
    """
    R64 = oracle_dissim(X, metric)
    oracle = vat_order_naive(R64.tolist())
    exact = bool(np.array_equal(np.asarray(order), np.asarray(oracle)))
    w_opt = tree_weight(R64, oracle)
    if w_opt <= 0.0:
        return (0.0 if exact else float("inf")), exact
    w_fit = tree_weight(R64, order)
    return max(0.0, (w_fit - w_opt) / w_opt), exact


# ------------------------------------------------------------------
# Certification
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CertResult:
    """One certified cell of the (generator × rung × policy) sweep."""

    generator: str
    method: str
    metric: str
    mode: str
    dtype_requested: str
    dtype_ran: str          # after any counted bf16 fallback
    kappa: float
    conditioned: bool
    fallbacks: int
    excess: float
    bound: float
    exact: bool
    ok: bool


def _bound_for(dtype_ran: str, slack: float = 0.0) -> float:
    return (EXCESS_BF16 if dtype_ran == "bf16" else EXCESS_F32) + slack


def certify_fit(X, *, method: str = "auto", metric: str = "euclidean",
                policy=None, device="cuda", generator: str = "custom",
                slack: float = 0.0) -> CertResult:
    """Run one fit through FastVAT and score it against the f64 oracle.

    The fit goes through the full public path — admission, the numerics
    pre-pass, rung dispatch — on ``device`` (the card's kernels by
    default, the plain versions with "cpu"), so what is certified is what
    users run.
    ``slack`` widens the bound by a rung-intrinsic allowance; ``sweep``
    supplies the approx rung's measured safe-policy baseline here so
    approx cells certify "no numerics error ADDED", not "no kNN defect".
    """
    from repro_torch.api.facade import FastVAT
    policy = as_policy(policy if policy is not None else NumericsPolicy())
    fv = FastVAT(method=method, metric=metric, numerics=policy,
                 device=device).fit(np.asarray(X, np.float32))
    rep = fv.result.meta.numerics
    excess, exact = ordering_excess(X, fv.order(), metric)
    bound = _bound_for(rep.dtype, slack)
    return CertResult(generator=generator, method=fv.method_resolved,
                      metric=metric, mode=policy.mode,
                      dtype_requested=policy.dtype, dtype_ran=rep.dtype,
                      kappa=rep.kappa, conditioned=rep.conditioned,
                      fallbacks=rep.fallbacks, excess=excess, bound=bound,
                      exact=exact, ok=bool(exact or excess <= bound))


#: The default certification matrix: every exact rung the ladder
#: auto-dispatches plus the approx rung, under the shipping policies.
DEFAULT_METHODS = ("vat", "ivat", "flashvat", "approx")
DEFAULT_POLICIES = (NumericsPolicy(mode="auto"),
                    NumericsPolicy(mode="safe"),
                    NumericsPolicy(mode="auto", dtype="bf16"))


def sweep(*, methods=DEFAULT_METHODS, metrics=CONDITIONED_METRICS,
          policies=DEFAULT_POLICIES, generators=None, seed: int = 0,
          n: int = 64, device="cuda") -> list[CertResult]:
    """The full adversarial sweep; deterministic in ``seed``."""
    gens = generators if generators is not None else GENERATORS
    out: list[CertResult] = []
    for gname, gen in gens.items():
        # crc32, not hash(): string hashing is salted per process and
        # the sweep must be bitwise-reproducible across runs
        gsalt = zlib.crc32(gname.encode()) & 0xFFFF
        rng = np.random.default_rng(np.random.SeedSequence([seed, gsalt]))
        X = gen(rng, n)
        for metric in metrics:
            approx_base: float | None = None
            for method in methods:
                for policy in policies:
                    slack = 0.0
                    if method == "approx":
                        if approx_base is None:
                            # the rung's intrinsic kNN spanning defect,
                            # measured once under the best-numerics
                            # policy (safe: conditioned + direct form)
                            approx_base = certify_fit(
                                X, method="approx", metric=metric,
                                policy=NumericsPolicy(mode="safe"),
                                device=device).excess
                        slack = approx_base
                    out.append(certify_fit(
                        X, method=method, metric=metric, policy=policy,
                        device=device, generator=gname,
                        slack=slack))
    return out


def summarize(results: list[CertResult]) -> str:
    """Human-readable table of a sweep (one line per cell)."""
    lines = [f"{'generator':<16} {'method':<9} {'metric':<12} "
             f"{'mode':<5} {'dtype':<5} {'kappa':>10} {'excess':>10} "
             f"{'bound':>8}  ok"]
    for r in results:
        lines.append(
            f"{r.generator:<16} {r.method:<9} {r.metric:<12} "
            f"{r.mode:<5} {r.dtype_ran:<5} {r.kappa:>10.3g} "
            f"{r.excess:>10.3g} {r.bound:>8.1g}  "
            f"{'OK' if r.ok else 'FAIL'}"
            + ("  (exact)" if r.exact else "")
            + (f"  [bf16 fallback x{r.fallbacks}]" if r.fallbacks else ""))
    fails = sum(not r.ok for r in results)
    lines.append(f"{len(results)} cells, {fails} failing")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Adversarial numerics certification sweep")
    parser.add_argument("--smoke", action="store_true",
                        help="CI-sized sweep: one metric, smaller matrix")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help='where the fits run: "cuda" (default, the '
                             'CUDA kernels) or "cpu" (their plain versions)')
    args = parser.parse_args(argv)
    if args.smoke:
        results = sweep(methods=("vat", "flashvat"),
                        metrics=("euclidean",),
                        generators={k: GENERATORS[k] for k in
                                    ("offset_clusters", "near_duplicates")},
                        seed=args.seed, n=args.n, device=args.device)
    else:
        results = sweep(seed=args.seed, n=args.n, device=args.device)
    print(summarize(results))
    return 1 if any(not r.ok for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())

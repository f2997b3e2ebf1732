"""The rung registry: method names -> fitters + capability flags.

``FastVAT`` is data-driven dispatch over this table, as in
``repro/api/registry.py``.  Each ``Rung`` entry owns its fitter (an
adapter that runs a ``repro_torch.core`` rung and wraps its output into
the uniform ``TendencyResult``), its capability flags and its
auto-selection threshold.

The port registers every rung of the reference: ``vat``, ``ivat``,
``svat``, ``flashvat``, ``bigvat``, ``approx``, ``dvat`` and ``embed``;
``vat``, ``flashvat`` and ``approx`` cover every n under auto-selection.
``UNPORTED`` lists the reference's rungs the port lacks: none.

>>> from repro_torch.api import registry
>>> sorted(registry.registered())
['approx', 'bigvat', 'dvat', 'embed', 'flashvat', 'ivat', 'svat', 'vat']
>>> registry.select_method(100), registry.select_method(10_000)
('vat', 'flashvat')
>>> registry.select_method(1_000_000)
'approx'
>>> registry.select_method(1_000_000, precomputed=True)   # matrix exists
'vat'
>>> [r for r in registry.registered() if registry.get_rung(r).supports_batch]
['vat', 'ivat', 'flashvat']
>>> registry.select_method(10_000, batched=True)
'flashvat'
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import core
from repro_torch.api.result import SALT_FIT, ResultMeta, TendencyResult
from repro_torch.core.bigvat import DEFAULT_BLOCK
from repro_torch.kernels import ops as kops
from repro_torch.monitor.probes import callable_fingerprint

#: Auto-selection thresholds, the reference's: materialized exact VAT up to
#: SMALL_N, matrix-free exact VAT (flashvat) to MEDIUM_N, the kNN-graph
#: approximation (approx) beyond.
SMALL_N = 2_048
MEDIUM_N = 50_000

#: Smallest n the flashvat rung auto-shards over a process group of more
#: than one rank (the reference's): below it the per-step collectives cost
#: more than they parallelize.
FLASH_SHARD_MIN_N = 4_096

#: Rungs of the reference the port does not have: none is left.
UNPORTED: tuple[str, ...] = ()


class RungOptions(NamedTuple):
    """Facade knobs forwarded to a fitter (metric/seed/device ride on
    ``ResultMeta``).

    ``sample_size`` is m, the representatives flashvat's banded render
    draws (and the s of svat, bigvat and dvat's image).  ``block`` is the
    row-block size of bigvat's tiled assignment pass.  ``turbo`` picks
    flashvat's traversal engine: None (default) lets the rung choose — the
    persistent kernel solo, or the sharded engine when the default process
    group has more than one rank and n is worth the collectives; True
    forces the solo persistent kernel; False the stepwise engine (solo).

    ``knn_k`` is the approx rung's accuracy knob: neighbours kept per point
    in the kNN graph whose spanning tree orders the data; the error it
    leaves is reported on ``ResultMeta.approx``.

    ``num_form`` is the numerics shield's tile-form plan: "gram" (default
    — the ‖x‖²+‖y‖²−2x·y form) or "direct" (per-coordinate (x−y)², no
    cancellation).  The facade sets it from ``numerics.resolve``.

    ``encoder`` is the ``embed`` rung's model hook: a callable mapping the
    fit input to an (n, d) activation matrix (DeepVAT-style).  The facade
    encodes before dispatch and leaves this None; set it when driving the
    rung directly through the registry.
    """
    sample_size: int = 256
    block: int = DEFAULT_BLOCK
    turbo: bool | None = None
    knn_k: int = 15
    encoder: Any = None
    num_form: str = "gram"


Fitter = Callable[[Any, ResultMeta, RungOptions], TendencyResult]


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Per-rung wall-time model — the SLO router's cost data.

    ``predict_us(n, batch) = base_us + batch * (per_point_us * n +
    per_sq_point_us * n^2)``.  The coefficients of the built-in rungs are
    fitted to fit walls measured on the card (the calibration note above
    the registrations); they exist to *rank* rungs and gate SLOs, they are
    not latency promises.

    Attributes:
      base_us: fixed dispatch + host-glue cost per fit.
      per_point_us: O(n) coefficient (kNN edges, sampling passes, the
        matrix-free engines' step floor).
      per_sq_point_us: O(n^2) coefficient (materialized matrices, the
        matrix-free engines' recompute work).
      cap_n: feasibility ceiling — the (n, n) memory wall of the
        materialized rungs; the router never offers a rung past it no
        matter how generous the SLO.
    """

    base_us: float
    per_point_us: float = 0.0
    per_sq_point_us: float = 0.0
    cap_n: int | None = None

    def predict_us(self, n: int, batch: int = 1) -> float:
        """Predicted wall microseconds for a (batch, n, d)-ish fit."""
        per = self.per_point_us * n + self.per_sq_point_us * float(n) * n
        return self.base_us + batch * per

    def feasible(self, n: int) -> bool:
        """Whether the rung is offered at all at this n."""
        return self.cap_n is None or n <= self.cap_n


def predict_latency_us(method: str, n: int, *, batch: int = 1) -> float | None:
    """Predicted fit latency of a registered rung; None when unmodeled."""
    model = get_rung(method).latency_model
    return None if model is None else model.predict_us(n, batch=batch)


def select_method_for_slo(n: int, slo_us: float, *, batch: int = 1,
                          restrict=None) -> str:
    """Pick the rung to run under a latency SLO (the serving router).

    Among the feasible, latency-modeled rungs (optionally restricted to a
    candidate set), return the **highest-fidelity rung the budget
    affords** — fidelity read from each rung's explicit ``fidelity`` rank,
    not proxied by predicted cost, since a coarser rung can predict
    costlier at small n.  Ties in fidelity go to the cheaper rung.  When
    no candidate fits the SLO, degrade to the cheapest feasible rung (best
    effort beats an error under load); callers that need a hard guarantee
    compare ``predict_latency_us`` against the SLO themselves.

    Args:
      n: points per dataset.
      slo_us: the latency budget in microseconds.
      batch: datasets per dispatch (coalesced serving amortizes base
        cost but multiplies per-dataset work).
      restrict: iterable of method names to choose among; None means
        every registered rung with a latency model.

    Returns:
      The selected method name.

    Raises:
      LookupError: no feasible modeled candidate exists.
    """
    names = tuple(restrict) if restrict is not None else registered()
    cands = []
    for name in names:
        model = get_rung(name).latency_model
        if model is not None and model.feasible(n):
            cands.append((name, model.predict_us(n, batch=batch)))
    if not cands:
        raise LookupError(
            f"no latency-modeled rung is feasible at n={n} "
            f"(candidates considered: {list(names)})")
    fitting = [c for c in cands if c[1] <= slo_us]
    if fitting:
        return max(fitting,
                   key=lambda c: (get_rung(c[0]).fidelity, -c[1]))[0]
    return min(cands, key=lambda c: c[1])[0]


@dataclasses.dataclass(frozen=True)
class Rung:
    """One registered VAT method.

    Attributes:
      name: the ``method=`` string.
      fit: solo fitter — (X_or_D tensor on the fit's device, meta,
        options) -> TendencyResult.
      fit_batch: batched fitter over a (b, n, d) stack (or a (b, n, n)
        precomputed stack); None means the rung doesn't batch.
      supports_precomputed: accepts metric="precomputed" input.
      auto_threshold: largest n ``select_method`` hands this rung
        (math.inf = unbounded fallback); None = never auto-selected.
      check: environment requirement run before a fit with n (dvat's
        process group), raising when it is not met; None = none.
      latency_model: wall-time model for SLO routing
        (``select_method_for_slo``); None = the router never offers the
        rung (it stays reachable through an explicit ``method=``).
      fidelity: explicit rank of how faithful the rung's picture is
        (higher = more faithful: exact geodesic > exact raw > banded
        render > sampled/approximate); the SLO router picks the
        highest-fidelity rung that fits the budget.
      description: one-liner for docs/tooling.
    """

    name: str
    fit: Fitter
    fit_batch: Fitter | None = None
    supports_precomputed: bool = False
    auto_threshold: float | None = None
    check: Callable[[int], None] | None = None
    latency_model: LatencyModel | None = None
    fidelity: float = 0.0
    description: str = ""

    @property
    def supports_batch(self) -> bool:
        return self.fit_batch is not None


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


def get_rung(name: str) -> Rung:
    """Look up a registered rung by method name."""
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
                  batched: bool = False, strict: bool = False) -> str:
    """The auto-selection policy, data-driven over rung capabilities.

    The candidates are the registered rungs with a threshold, the same
    auto-selectable rungs as the reference's, so the choice is its choice.

    Args:
      n: points per dataset.
      precomputed: restrict to rungs accepting metric="precomputed".
      batched: restrict to rungs with a batched fitter.
      strict: raise LookupError when no candidate's threshold covers n
        instead of falling back to the largest-threshold candidate (the
        fallback serves precomputed input, where the O(n^2) matrix
        already exists so the exact rung stays the right answer).

    Returns:
      The selected method name.
    """
    cands = [(r.auto_threshold, r.name) for r in _REGISTRY.values()
             if r.auto_threshold is not None
             and (r.supports_precomputed or not precomputed)
             and (r.supports_batch or not batched)]
    cands.sort()
    if not cands:
        raise LookupError(f"no auto-selectable rung matches "
                          f"(precomputed={precomputed}, batched={batched})")
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


def _vat_result_batch(data, meta: ResultMeta,
                      opts: RungOptions) -> core.VATResult:
    if meta.metric == "precomputed":
        return core.vat_batch_from_dist(data)
    return core.vat_batch(data, metric=meta.metric, form=opts.num_form)


def _fit_vat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    res = _vat_result(data, meta, opts)
    return TendencyResult(order=res.order, rstar=res.rstar, ivat_image=None,
                          sample_idx=None, extension_labels=None, meta=meta)


def _fit_vat_batch(data, meta: ResultMeta,
                   opts: RungOptions) -> TendencyResult:
    res = _vat_result_batch(data, meta, opts)
    return TendencyResult(order=res.order, rstar=res.rstar, ivat_image=None,
                          sample_idx=None, extension_labels=None, meta=meta)


def _fit_ivat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    res = _vat_result(data, meta, opts)
    iv = core.ivat_from_vat(res.rstar)
    return TendencyResult(order=res.order, rstar=res.rstar, ivat_image=iv,
                          sample_idx=None, extension_labels=None, meta=meta)


def _fit_ivat_batch(data, meta: ResultMeta,
                    opts: RungOptions) -> TendencyResult:
    res = _vat_result_batch(data, meta, opts)
    iv = core.ivat_from_vat(res.rstar)     # (b, n, n): one launch
    return TendencyResult(order=res.order, rstar=res.rstar, ivat_image=iv,
                          sample_idx=None, extension_labels=None, meta=meta)


def _svat_result(Xf: torch.Tensor, meta: ResultMeta,
                 opts: RungOptions) -> core.SVATResult:
    return core.svat(Xf, meta.generator(SALT_FIT),
                     s=min(opts.sample_size, meta.n), metric=meta.metric)


def _fit_svat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    """sVAT: the exact VAT of s maximin-sampled points; ``order`` and
    ``rstar`` are the sample's, ``sample_idx`` its dataset rows."""
    res = _svat_result(data.float(), meta, opts)
    return TendencyResult(order=res.vat.order, rstar=res.vat.rstar,
                          ivat_image=None, sample_idx=res.sample_idx,
                          extension_labels=None, meta=meta)


def _fit_bigvat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    """Big-VAT: the svat sample (the same start as svat's, from
    ``meta.generator(SALT_FIT)``), its iVAT image, and the tiled
    nearest-prototype extension to all n points; ``order`` is all n
    points, ``rstar`` and ``ivat_image`` the sample's, and the image is
    expanded by ``group_sizes``."""
    res = core.bigvat(data.float(), meta.generator(SALT_FIT),
                      s=opts.sample_size, block=opts.block,
                      metric=meta.metric)
    return TendencyResult(order=res.order, rstar=res.sample.vat.rstar,
                          ivat_image=res.ivat,
                          sample_idx=res.sample.sample_idx,
                          extension_labels=res.labels,
                          group_sizes=res.group_sizes, meta=meta)


def _flash_groups(n: int, m: int):
    """Partition VAT-order positions 0..n-1 into m contiguous groups.

    Returns (sizes (m,) int64, mids (m,) int64): per-group lengths
    (remainder spread over the leading groups) and each group's middle
    position — the representative whose distances render that band.
    """
    base, extra = divmod(n, m)
    sizes = np.full(m, base, np.int64)
    sizes[:extra] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return sizes, starts + sizes // 2


def _rep_ivat(Rrep: torch.Tensor) -> torch.Tensor:
    """iVAT image of a representative matrix, returned in band order.

    The Havens-Bezdek recurrence holds only along a Prim traversal of the
    matrix it runs on, and band order (representatives sorted by their
    position in the full-n ordering) is generally not one — so the
    geodesics run along the representatives' own Prim order
    (``vat_from_dist``) and are permuted back to band order.  A (b, m, m)
    stack runs lane by lane in the launches of one matrix
    (``vat_batch_from_dist``, the (b, m, m) iVAT launch, two gathers).
    """
    if Rrep.dim() == 3:
        sres = core.vat_batch_from_dist(Rrep)
        iv_s = core.ivat_from_vat(sres.rstar)
        rank = torch.empty_like(sres.order)
        rank.scatter_(1, sres.order, torch.arange(
            Rrep.shape[1], device=Rrep.device).expand_as(sres.order))
        return core.reorder_batch(iv_s, rank)
    sres = core.vat_from_dist(Rrep)
    iv_s = core.ivat_from_vat(sres.rstar)
    m = Rrep.shape[0]
    rank = torch.empty(m, dtype=torch.int64, device=Rrep.device)
    rank[sres.order] = torch.arange(m, device=Rrep.device)
    return iv_s.index_select(0, rank).index_select(1, rank)


def _world_size() -> int:
    """Ranks of the default process group; 1 when none is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _flash_order(Xf: torch.Tensor, meta: ResultMeta,
                 opts: RungOptions) -> core.FlashVATResult:
    """The flashvat rung's engine, the reference's rule: ``turbo`` None
    takes the sharded engine over the default process group when it has
    more than one rank, n >= ``FLASH_SHARD_MIN_N`` and the numerics plan is
    "gram" (the sharded engine speaks the gram form only), and the solo
    persistent kernel otherwise; True forces the solo persistent kernel,
    False the stepwise engine.  The orders are the same bit for bit."""
    if (opts.turbo is None and _world_size() > 1
            and meta.n >= FLASH_SHARD_MIN_N and opts.num_form == "gram"):
        return core.vat_matrix_free_sharded(Xf, metric=meta.metric)
    return core.vat_matrix_free(Xf, metric=meta.metric, form=opts.num_form,
                                turbo=opts.turbo is not False)


def _band_render(Xf: torch.Tensor, order: torch.Tensor, meta: ResultMeta,
                 opts: RungOptions) -> TendencyResult:
    """bigvat-style banded rendering of a full-n ordering.

    m = sample_size representatives sit at the middle of m contiguous bands
    of the ordering; their (m, m) matrix inherits band order, and
    ``TendencyResult.image`` expands it by the band sizes, so the picture
    shows all n points while only an (m, m) object exists.  The iVAT
    companion runs along the representatives' own Prim order
    (``_rep_ivat``).  Shared by the flashvat (exact order) and approx
    (kNN-MST order) rungs.
    """
    n, m = meta.n, min(opts.sample_size, meta.n)
    sizes, mids = _flash_groups(n, m)
    dev = Xf.device
    rep_idx = order.index_select(0, torch.as_tensor(mids, device=dev))
    Rrep = kops.pairwise_dist(Xf.index_select(0, rep_idx),
                              metric=meta.metric, form=opts.num_form)
    iv = _rep_ivat(Rrep)
    gid = torch.as_tensor(np.repeat(np.arange(m, dtype=np.int64), sizes),
                          device=dev)
    labels = torch.empty(n, dtype=torch.int64, device=dev)
    labels[order] = gid
    return TendencyResult(order=order, rstar=Rrep, ivat_image=iv,
                          sample_idx=rep_idx, extension_labels=labels,
                          group_sizes=torch.as_tensor(sizes, device=dev),
                          meta=meta)


def _fit_flashvat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    """Flash-VAT: the exact full-n ordering without the (n, n) matrix, then
    the banded render.  The points are cast to f32 first, so bf16 storage
    reaches neither Prim kernel."""
    Xf = data.float().contiguous()
    res = _flash_order(Xf, meta, opts)
    return _band_render(Xf, res.order, meta, opts)


def _fit_flashvat_batch(data, meta: ResultMeta,
                        opts: RungOptions) -> TendencyResult:
    """Batched Flash-VAT: each lane's exact matrix-free ordering (one
    persistent launch of b groups of CTAs, or n - 1 batched steps), then
    the banded render of every lane in the launches of one: the (b, m, m)
    representatives' matrices (one ``pairwise_dist_batch`` launch) and
    their iVAT images (``_rep_ivat`` on the stack).  Each lane equals the
    solo ``_fit_flashvat`` of its dataset bit for bit; no (b, n, n) object
    exists."""
    Xf = data.float().contiguous()
    res = core.vat_matrix_free_batch(Xf, metric=meta.metric,
                                     form=opts.num_form,
                                     turbo=opts.turbo is not False)
    b, n, d = Xf.shape
    m = min(opts.sample_size, n)
    sizes, mids = _flash_groups(n, m)
    dev = Xf.device
    rep_idx = res.order[:, torch.as_tensor(mids, device=dev)]       # (b, m)
    prot = torch.gather(Xf, 1, rep_idx[:, :, None].expand(b, m, d))
    Rrep = kops.pairwise_dist_batch(prot, metric=meta.metric,
                                    form=opts.num_form)
    iv = _rep_ivat(Rrep)
    gid = torch.as_tensor(np.repeat(np.arange(m, dtype=np.int64), sizes),
                          device=dev)
    labels = torch.empty((b, n), dtype=torch.int64, device=dev)
    labels.scatter_(1, res.order, gid.expand(b, n))
    return TendencyResult(order=res.order, rstar=Rrep, ivat_image=iv,
                          sample_idx=rep_idx, extension_labels=labels,
                          group_sizes=torch.as_tensor(sizes, device=dev),
                          meta=meta)


def _fit_approx(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    """Approx-VAT: the kNN-graph Borůvka MST ordering, then the banded
    render.

    The ordering is ``core.approx_vat``'s — a Prim walk of the minimum
    spanning tree of the k-nearest-neighbour graph (exact kNN up to
    ``EXACT_KNN_N``, anchored beyond) — exact whenever the kNN graph holds
    the true MST (always at k = n-1).  The error it leaves is measured and
    carried on ``ResultMeta.approx``.  The kNN stages and the repair use
    the gram form; the render uses ``opts.num_form``.  No (n, n) object
    at any stage; the points are cast to f32 first.
    """
    Xf = data.float().contiguous()
    res = core.approx_vat(Xf, k=opts.knn_k, metric=meta.metric)
    meta = dataclasses.replace(meta, approx=res.stats)
    return _band_render(Xf, res.order, meta, opts)


def encoder_required() -> ValueError:
    """The ``embed`` rung's error for a fit with no encoder."""
    return ValueError(
        "method='embed' needs an encoder: pass options.encoder (a "
        "callable X -> activations), or pre-encoded activations with "
        "the encoder fingerprint on meta.encoder — e.g. via "
        "FastVAT.fit(X, encoder=...) / FastVAT.fit_embeddings(...)")


def encode_rows(encoder, X):
    """Activations of X as f32 rows, and their encoder's fingerprint.

    A callable encoder runs on X (fingerprint: ``callable_fingerprint``);
    a string means X is already the activations and the string is their
    fingerprint.  Any leading shape is flattened to rows.  A tensor keeps
    its device and leaves autograd; anything else becomes a numpy array.
    """
    if callable(encoder):
        acts, fingerprint = encoder(X), callable_fingerprint(encoder)
    else:
        acts, fingerprint = X, str(encoder)
    acts = (acts.detach().float() if isinstance(acts, torch.Tensor)
            else np.asarray(acts, np.float32))
    if acts.ndim > 2:
        acts = acts.reshape(-1, acts.shape[-1])
    return acts, fingerprint


def _fit_embed(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    """The embeddings front-end rung (DeepVAT): assess activations.

    Raw inputs (pixels, tokens) are rarely clusterable; learned
    embeddings are.  This rung maps the input through an encoder —
    ``opts.encoder`` (a callable X -> (n, d) activations), or the data is
    already pre-encoded and ``meta.encoder`` carries the fingerprint —
    then delegates to whatever rung ``select_method`` picks for the
    activation count (``encode_rows``).  Activations that are a tensor on
    the fit's device stay there; others are copied there.  ``meta.method``
    stays "embed" and ``meta.encoder`` records provenance; everything else
    (images, assess) is the inner rung's standard output.
    """
    enc = opts.encoder
    if callable(enc):
        acts, fingerprint = encode_rows(enc, data)
        meta = dataclasses.replace(meta, encoder=meta.encoder or fingerprint)
    elif meta.encoder:
        acts, _ = encode_rows(meta.encoder, data)   # pre-encoded
    else:
        raise encoder_required()
    acts = torch.as_tensor(acts, device=torch.device(meta.device))
    meta = dataclasses.replace(meta, n=int(acts.shape[0]))
    inner = get_rung(select_method(meta.n))
    return inner.fit(acts, meta, opts)


def _check_dvat(n: int):
    """dvat needs a process group of more than one rank whose size divides
    n: RuntimeError below two ranks (as the reference below two devices),
    ValueError when the size does not divide n."""
    ranks = _world_size()
    if ranks < 2:
        raise RuntimeError(
            f"method='dvat' needs a torch.distributed process group of more "
            f"than one rank, found {ranks}; use 'flashvat' on one device")
    if n % ranks:
        raise ValueError(
            f"method='dvat' needs n divisible by the world size "
            f"({n} % {ranks} != 0); pad or truncate X first")


def _fit_dvat(data, meta: ResultMeta, opts: RungOptions) -> TendencyResult:
    """dvat: the full-n order of the distributed engine, with the svat
    image of a maximin sample, so the result has the uniform
    ``image()`` / ``assess()`` surface."""
    Xf = data.float()
    dres = core.dvat(Xf, metric=meta.metric)
    sres = _svat_result(Xf, meta, opts)
    return TendencyResult(order=dres.order, rstar=sres.vat.rstar,
                          ivat_image=None, sample_idx=sres.sample_idx,
                          extension_labels=None, meta=meta)


# Latency-model calibration, fitted to fit walls measured on one NVIDIA H100
# 80GB HBM3 at a 700 W power limit by chip_smoke.py (PERF.md §5 and §6
# give the runs): vat 12.7 ms at n = 2,048 and 34.2 ms for fit_many of 8
# lanes at 2,048; ivat 11.5 ms at 2,048 and 109 ms at 16,384; flashvat
# 11.9 ms at 2,048, 310 ms at 50,000 and 1.30 s for 4 lanes at 50,000;
# approx 5.13 s and bigvat 0.337 s at 1,000,000; svat 94.3 ms at
# 50,000.
#
#   * vat and ivat share per_point / per_sq_point, solved from the lanes'
#     cost (8 lanes against one at 2,048) and ivat's growth from 2,048 to
#     16,384; each base is its fit at 2,048 less that per-lane cost.
#   * flashvat: per_point is the persistent kernel's 3.40 us step floor;
#     base and per_sq_point are a least-squares fit (relative error) to
#     the three walls.  4 lanes cost more than 4 solo fits (the lanes'
#     rows leave shared memory), so the 50,000-point walls alone would
#     give a negative base; the 2,048-point wall holds the fixed cost of
#     the seed scan, the traversal's launch and the render.
#   * approx, bigvat and svat: one wall each, all of it per point.
#
# cap_n = 20_000 is the materialized rungs' (n, n) memory wall (1.6 GB
# f32 a lane), as in the reference.  dvat carries no model: its cost is
# shaped by the process group, not by n.
_MATERIALIZE_CAP_N = 20_000
_VAT_PER_POINT_US = 0.837
_VAT_PER_SQ_POINT_US = 3.24e-4

register(Rung(
    name="vat", fit=_fit_vat, fit_batch=_fit_vat_batch,
    supports_precomputed=True, auto_threshold=SMALL_N,
    latency_model=LatencyModel(base_us=9.63e3,
                               per_point_us=_VAT_PER_POINT_US,
                               per_sq_point_us=_VAT_PER_SQ_POINT_US,
                               cap_n=_MATERIALIZE_CAP_N),
    fidelity=50.0,
    description="exact VAT — O(n^2) matrix fits easily"))
register(Rung(
    name="ivat", fit=_fit_ivat, fit_batch=_fit_ivat_batch,
    supports_precomputed=True, auto_threshold=None,
    latency_model=LatencyModel(base_us=8.43e3,
                               per_point_us=_VAT_PER_POINT_US,
                               per_sq_point_us=_VAT_PER_SQ_POINT_US,
                               cap_n=_MATERIALIZE_CAP_N),
    fidelity=60.0,
    description="exact VAT + geodesic (iVAT) image; opt-in"))
register(Rung(
    name="svat", fit=_fit_svat, auto_threshold=None,
    latency_model=LatencyModel(base_us=0.0, per_point_us=1.886),
    fidelity=30.0,
    description="maximin sample VAT, O(ns + s^2); opt-in"))
register(Rung(
    name="flashvat", fit=_fit_flashvat, fit_batch=_fit_flashvat_batch,
    supports_precomputed=False, auto_threshold=MEDIUM_N,
    latency_model=LatencyModel(base_us=4.65e3, per_point_us=3.40,
                               per_sq_point_us=5.77e-5),
    fidelity=40.0,
    description="matrix-free exact VAT (Flash-VAT): persistent Prim kernel, "
                "O(n·d) memory, no (n, n) object"))
register(Rung(
    name="bigvat", fit=_fit_bigvat, auto_threshold=None,
    latency_model=LatencyModel(base_us=0.0, per_point_us=0.337),
    fidelity=20.0,
    description="maximin sample VAT + tiled nearest-prototype extension "
                "to all n points, no (n, n) object; opt-in"))
register(Rung(
    name="approx", fit=_fit_approx, supports_precomputed=False,
    auto_threshold=math.inf,
    latency_model=LatencyModel(base_us=0.0, per_point_us=5.13),
    fidelity=10.0,
    description="kNN-graph Borůvka MST ordering (kNN kernel), O(n·k) "
                "memory, the million-point rung; error on meta.approx"))
register(Rung(
    name="dvat", fit=_fit_dvat, check=_check_dvat, auto_threshold=None,
    description="matrix-free distributed VAT over a torch.distributed "
                "process group; needs more than one rank"))
register(Rung(
    name="embed", fit=_fit_embed, auto_threshold=None,
    description="embeddings front-end (DeepVAT): encode, then run the "
                "exact/approx ladder on activations; encoder "
                "fingerprint on meta.encoder"))

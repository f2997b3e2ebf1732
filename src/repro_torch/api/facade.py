"""FastVAT — the port's front door, on PyTorch and the H100.

The same surface as ``repro.FastVAT`` for the rungs ported so far:

  n <= SMALL_N  (2_048)   exact ``vat``      — O(n^2) matrix fits easily
  n <= MEDIUM_N (50_000)  exact ``flashvat`` — matrix-free, persistent
                                               Prim kernel, banded render
  larger                  ``approx``         — kNN-graph Borůvka MST
                                               (kNN kernel), banded render;
                                               error on ``meta.approx``

plus the opt-in rungs ``ivat`` (the geodesic image), ``svat`` (the VAT of
a maximin sample), ``bigvat`` (the svat sample extended to all n points by
a tiled nearest-prototype pass; np.memmap input is copied to the device
once and skips the numerics pre-pass) and ``dvat`` (matrix-free
distributed VAT over a ``torch.distributed`` process group of more than
one rank, with the svat image), and the embeddings front end ``embed``
(DeepVAT: ``fit(X, encoder=fn)`` runs the ladder on ``fn(X)``, and
``fit_embeddings(params, cfg, batch)`` on a zoo model's final hidden
states, on the card; the encoder's fingerprint lands on
``result.meta.encoder``).  When the default process group has more
than one rank, flashvat shards its traversal over it from n = 4,096
(``turbo=None``, the gram form), each rank calling ``fit`` on the same
points.  The fit runs on
``device`` (default
"cuda": the CUDA kernels of ``kernels/csrc``); ``device="cpu"`` runs the
plain PyTorch versions.  Without a GPU the default device raises
``RuntimeError`` at ``fit`` rather than carry on on the CPU.

>>> import numpy as np
>>> rng = np.random.default_rng(0)
>>> X = np.concatenate([rng.normal(size=(30, 3)),
...                     rng.normal(size=(30, 3)) + 8]).astype(np.float32)
>>> fv = FastVAT(device="cpu").fit(X)    # auto-selects by n
>>> fv.method_resolved
'vat'
>>> fv.image().shape
(60, 60)
>>> rep = fv.assess()                    # TendencyReport, dict-like
>>> (rep["method"], rep["k_est"], rep["clustered"])
('vat', 2, True)

``fit_many`` assesses a (b, n, d) stack of datasets in the launches of one
fit, each lane bit for bit its solo fit (rungs ``vat``, ``ivat`` and
``flashvat``; auto picks among them and refuses n past 50,000):

>>> fm = FastVAT(device="cpu").fit_many(np.stack([X, X[::-1].copy()]))
>>> fm.batched, fm.order().shape, fm.image().shape
(True, (2, 60), (2, 60, 60))
>>> [(r["batch_index"], r["k_est"]) for r in fm.assess()]
[(0, 2), (1, 2)]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import core
from repro_torch.api import registry
from repro_torch.api.metrics import as_dissimilarity, validate_metric
from repro_torch.api.registry import RungOptions, select_method
from repro_torch.api.result import (SALT_ASSESS, SALT_HOPKINS, ResultMeta,
                                    TendencyReport, TendencyResult,
                                    device_scope)
from repro_torch.api.validation import (InvalidInput, validate_dissimilarity,
                                       validate_points)
from repro_torch.core.bigvat import DEFAULT_BLOCK
from repro_torch.monitor.probes import encode_batch, model_fingerprint
from repro_torch.numerics import as_policy
from repro_torch.numerics import resolve as resolve_numerics


def _device(device) -> torch.device:
    """The fit's device; RuntimeError for CUDA on a machine without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FastVAT(device={str(device)!r}) needs a CUDA GPU and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return dev


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lives on ``dev`` ("cuda" meaning the current card)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return t.device == dev


#: Method names at import time ("auto" + built-in rungs). The live list —
#: including later third-party registrations — is ``registry.methods()``.
METHODS = registry.methods()

class FastVAT:
    """Facade over the registered rungs with auto-selection.

    Parameters
    ----------
    method:    "auto" or any name in ``registry.methods()``; "auto" picks
               by n at fit time.  "embed" needs an encoder (``fit(X,
               encoder=…)`` or ``fit_embeddings``).
    metric:    "euclidean" | "sqeuclidean" | "manhattan" | "cosine", or
               "precomputed" to pass ``fit`` an (n, n) matrix directly.
    seed:      the single seed every sampling path (device and host side)
               derives from — see ``ResultMeta``.
    sample_size: m, the representatives the banded render of flashvat and
               approx draws (its image and ``rstar`` are (m, m)), and the s
               of the svat and bigvat samples.
    block:     rows a tile of bigvat's nearest-prototype pass.
    turbo:     flashvat's traversal engine — None (default) the persistent
               kernel, or the sharded engine under a process group of more
               than one rank from n = 4,096; True the solo persistent
               kernel; False the stepwise engine (one fused step kernel per
               vertex); the same ordering every way.
    knn_k:     the approx rung's error-bound knob — neighbours per point in
               the kNN graph (default 15); exact at n - 1.
    validate:  admission-check inputs before they reach a kernel (finite
               values, real dtype, n >= 4, non-degenerate, no zero-norm
               rows under cosine) and fail with the typed
               ``InvalidInput``; ``False`` skips the pass.
    numerics:  the numerics shield's policy — a
               ``repro_torch.numerics.NumericsPolicy`` or a mode string
               ("fast" | "safe" | "auto", default "auto"); what ran lands
               on ``result.meta.numerics``.  bf16 storage keeps the
               points as bfloat16 on the device (f32 accumulation).
    device:    where the fit runs: "cuda" (default) launches the CUDA
               kernels, "cpu" runs their plain PyTorch versions.
    """

    def __init__(self, method: str = "auto", *, metric: str = "euclidean",
                 sample_size: int = 256, block: int = DEFAULT_BLOCK,
                 turbo: bool | None = None, knn_k: int = 15, seed: int = 0,
                 validate: bool = True, numerics="auto", device="cuda"):
        methods = registry.methods()
        if method not in methods:
            raise ValueError(f"method must be one of {methods}, "
                             f"got {method!r}")
        validate_metric(metric)
        self.method = method
        self.metric = metric
        self.sample_size = sample_size
        self.block = block
        self.turbo = turbo
        self.knn_k = knn_k
        self.seed = seed
        self.validate = validate
        self.numerics = as_policy(numerics)
        self.device = device
        self.method_resolved: str | None = None
        self.result: TendencyResult | None = None
        self._X: torch.Tensor | None = None

    @property
    def batched(self) -> bool:
        """True after ``fit_many`` (the result carries a batch axis)."""
        return self.result is not None and self.result.is_batched

    @classmethod
    def from_result(cls, result: TendencyResult, X=None) -> "FastVAT":
        """Adopt an externally produced fit (e.g. ``TendencyResult.
        from_arrays`` of a reference fit); ``X`` (the fitted points) is
        needed for ``assess()`` on non-precomputed metrics."""
        m = result.meta
        fv = cls(method=m.method, metric=m.metric, seed=m.seed,
                 sample_size=(m.sample_size if m.sample_size is not None
                              else 256),
                 knn_k=m.approx.k if m.approx is not None else 15,
                 device=m.device)
        fv.result = result
        fv.method_resolved = m.method
        fv._X = None if X is None else torch.tensor(
            np.asarray(X, np.float32), device=m.device)
        return fv

    # ------------------------------------------------------------- fit ----

    def _admit(self, X, *, batched: bool = False, name: str = "X"):
        """Admission, the numerics pre-pass and the move to the fit's
        device, for one dataset or a (b, ...) stack: (data tensor,
        ``NumericsReport``, or None for precomputed or np.memmap input).
        An f32 tensor already on the fit's device that the pre-pass leaves
        as it is is copied there, not through the host (the checks read a
        host copy); the copy is detached, so the fit neither follows the
        caller's later edits nor carries the caller's autograd graph."""
        dev = _device(self.device)
        src = X if isinstance(X, torch.Tensor) else None
        if src is not None:
            X = self._tensor_to_host(X)
        if self.metric == "precomputed":
            if self.validate:
                validate_dissimilarity(X)
            return torch.tensor(as_dissimilarity(X, batched=batched),
                                device=dev), None
        if self.validate:
            validate_points(X, batched=batched, name=name,
                            metric=self.metric)
        if batched:
            X = np.asarray(X, np.float32)
            if X.ndim != 3:
                raise ValueError(f"fit_many wants a (b, n, d) stack, got "
                                 f"shape {X.shape}")
        if isinstance(X, np.memmap):
            # out-of-core input skips the pre-pass, as the reference's
            # does: conditioning would materialize an O(n·d) copy
            return torch.tensor(np.asarray(X, np.float32), device=dev), None
        Xr, num_report = resolve_numerics(X, metric=self.metric,
                                          policy=self.numerics,
                                          batched=batched)
        if (src is not None and src.dtype == torch.float32 and _on(src, dev)
                and not num_report.conditioned and num_report.dtype == "f32"):
            return (src.detach().clone(memory_format=torch.contiguous_format),
                    num_report)
        data = torch.tensor(Xr, device=dev)
        if num_report.dtype == "bf16":  # exact: Xr is bf16-quantized
            data = data.to(torch.bfloat16)
        return data, num_report

    def _tensor_to_host(self, X: torch.Tensor) -> np.ndarray:
        """A tensor as a host array for admission.  A dtype numpy lacks
        (bfloat16, the float8s) is refused as the reference refuses its
        bf16 arrays, or, under ``validate=False``, widened to float32."""
        X = X.detach().cpu()
        if X.is_floating_point() and X.dtype not in (
                torch.float16, torch.float32, torch.float64):
            if self.validate:
                name = "D" if self.metric == "precomputed" else "X"
                raise InvalidInput(
                    "dtype", f"{name} must be a real numeric array, got "
                    f"dtype {str(X.dtype).removeprefix('torch.')}")
            X = X.float()
        return X.numpy()

    def _run(self, fitter, data, method: str, num_report,
             batch: int | None, encoder: str | None = None) -> "FastVAT":
        """Run a rung's fitter on admitted data and keep the result."""
        dev = data.device
        meta = ResultMeta(method=method, metric=self.metric,
                          n=int(data.shape[0 if batch is None else 1]),
                          batch=batch, seed=self.seed, device=str(dev),
                          sample_size=self.sample_size, encoder=encoder,
                          numerics=num_report)
        with device_scope(dev):
            self.result = fitter(data, meta, RungOptions(
                sample_size=self.sample_size, block=self.block,
                turbo=self.turbo, knn_k=self.knn_k,
                num_form=(num_report.form if num_report is not None
                          else "gram")))
        self.method_resolved = method
        self._X = data
        return self

    def fit(self, X, *, encoder=None) -> "FastVAT":
        """Run the resolved rung on one dataset.

        Args:
          X: (n, d) array-like of points (numpy, np.memmap, or a tensor on
            any device), or — with ``metric="precomputed"`` — an (n, n)
            dissimilarity matrix (square, symmetric, zero diagonal).
          encoder: route through the ``embed`` front-end rung
            (DeepVAT-style).  A callable maps X to an (n, d) activation
            matrix (any leading shape; flattened to rows; a tensor on the
            fit's device is copied there, detached) which the ladder then
            assesses; a string means X is *already* the activation matrix
            and the string is its encoder fingerprint.  Either way
            ``result.meta.encoder`` records provenance and the inner rung
            is auto-selected by activation count.

        Returns:
          self; ``self.result`` is the rung's ``TendencyResult``.
        """
        if encoder is not None:
            return self._fit_embed_front(X, encoder)
        if self.method == "embed":
            raise registry.encoder_required()
        data, num_report = self._admit(X)
        precomputed = self.metric == "precomputed"
        n = int(data.shape[0])
        method = (self.method if self.method != "auto"
                  else select_method(n, precomputed=precomputed))
        rung = registry.get_rung(method)
        if precomputed and not rung.supports_precomputed:
            raise ValueError(f"method {method!r} does not accept "
                             "metric='precomputed'")
        if rung.check is not None:
            rung.check(n)
        return self._run(rung.fit, data, method, num_report, None)

    def _fit_embed_front(self, X, encoder) -> "FastVAT":
        """fit(X, encoder=...) tail: encode, then run the embed rung.

        Encoding (``registry.encode_rows``, the rung's own routine)
        happens here, not inside the rung's fitter, so the
        activations, admitted and pre-passed as any fit's points, become
        ``self._X``: ``assess()``'s Hopkins probe then reads the embedding
        space the fit assessed, the DeepVAT semantics.
        """
        if self.metric == "precomputed":
            raise ValueError("encoder= assesses activations; it is "
                             "incompatible with metric='precomputed'")
        if self.method not in ("auto", "embed"):
            raise ValueError("encoder= routes through the 'embed' rung; "
                             "method must be 'auto' or 'embed', got "
                             f"{self.method!r}")
        acts, fingerprint = registry.encode_rows(encoder, X)
        data, num_report = self._admit(acts, name="activations")
        return self._run(registry.get_rung("embed").fit, data, "embed",
                         num_report, None, encoder=fingerprint)

    def fit_embeddings(self, params, cfg, batch) -> "FastVAT":
        """Assess the cluster tendency of a model's activations.

        The DeepVAT workflow for the model zoo: one forward pass on the
        params' device, the final hidden states flattened to
        (batch*seq, d_model) rows (``monitor.probes.encode_batch``), then
        the ``embed`` rung, which delegates to the exact/approx ladder by
        activation count.  The model's fingerprint — architecture identity
        + a weights digest — lands on ``result.meta.encoder``.

        Args:
          params: model parameters (``models.model.init_params``), on the
            fit's device.
          cfg: the ``ModelConfig`` matching params.
          batch: input batch dict (``data.tokens.make_batch``) — tokens
            plus any family extras (patches, enc_frames; labels run
            DeepSeek-V3's MTP block).

        Returns:
          self; ``self.result`` is a standard ``TendencyResult``.

        Raises:
          ValueError: the params live on another device than the fit's;
            the model never runs elsewhere in the fit's place.
        """
        dev = _device(self.device)
        if not _on(params["embed"], dev):
            raise ValueError(
                f"fit_embeddings: the params live on "
                f"{params['embed'].device}, and FastVAT(device="
                f"{self.device!r}) fits on {dev}; move the params there "
                "(or fit on their device)")
        acts = encode_batch(params, cfg, batch)
        return self.fit(acts, encoder=model_fingerprint(cfg, params))

    def fit_many(self, Xs) -> "FastVAT":
        """Assess a stack of datasets in the launches of one fit.

        Args:
          Xs: (b, n, d) array-like — b independent datasets of n points
            each (a list of equal-shape (n, d) arrays also works); with
            ``metric="precomputed"`` a (b, n, n) dissimilarity stack.

        Returns:
          self.  ``order()`` then gives (b, n), ``image()`` a (b, ·, ·)
          stack and ``assess()`` a list of b reports.

        Only rungs with a batched fitter batch (``vat``, ``ivat``,
        ``flashvat``); "auto" resolves among them and refuses n past the
        largest batching threshold (50,000).  The kernels take the lane as
        an axis, so the stack costs about the launches of one fit, and
        each lane's result is its solo ``fit`` bit for bit.  For larger n,
        loop ``fit()`` per dataset.
        """
        data, num_report = self._admit(Xs, batched=True)
        precomputed = self.metric == "precomputed"
        b, n = int(data.shape[0]), int(data.shape[1])
        method = self.method
        if method == "auto":
            try:
                # precomputed input may exceed the exact rung's threshold:
                # the O(n^2) matrix already exists, so fall back to it
                method = select_method(n, precomputed=precomputed,
                                       batched=True, strict=not precomputed)
            except LookupError:
                cap = max(r.auto_threshold for r in
                          map(registry.get_rung, registry.registered())
                          if r.supports_batch
                          and r.auto_threshold is not None)
                raise ValueError(
                    f"fit_many batches the exact rungs only (n <= {cap}),"
                    f" got per-dataset n={n}; loop fit() per dataset for"
                    " the approx rung") from None
        rung = registry.get_rung(method)
        if not rung.supports_batch:
            batchable = [r for r in registry.registered()
                         if registry.get_rung(r).supports_batch]
            raise ValueError(
                f"fit_many supports methods with a batched fitter "
                f"({batchable} or 'auto'), got {self.method!r}")
        if precomputed and not rung.supports_precomputed:
            raise ValueError(f"method {method!r} does not accept "
                             "metric='precomputed'")
        return self._run(rung.fit_batch, data, method, num_report, b)

    # --------------------------------------------------------- queries ----

    def _require_fit(self) -> TendencyResult:
        if self.result is None:
            raise RuntimeError("call fit(X) first")
        return self.result

    def order(self) -> np.ndarray:
        """VAT ordering, as a host array: of all n points (vat, ivat,
        bigvat, flashvat, approx, dvat) or of the sample (svat —
        ``sample_indices()`` maps it back to dataset rows); (b, n) after
        ``fit_many``."""
        return self._require_fit().order.cpu().numpy()

    def sample_indices(self) -> np.ndarray | None:
        """Dataset rows of the representatives (flashvat, approx) or of the
        maximin sample (svat, bigvat, dvat), else None."""
        idx = self._require_fit().sample_idx
        return None if idx is None else idx.cpu().numpy()

    def image(self, *, resolution: int = 256,
              use_ivat: bool | None = None) -> np.ndarray:
        """The reordered dissimilarity image (the thing you look at); see
        ``TendencyResult.image``."""
        return self._require_fit().image(resolution=resolution,
                                         use_ivat=use_ivat)

    def _hopkins_subsample(self, X: torch.Tensor, meta: ResultMeta,
                           cap: int = 2_048) -> torch.Tensor:
        """Uniform random rows of X (all of them up to ``cap``) for the
        Hopkins statistic, as f32; the rows come from ``meta.host_rng``.
        Maximin prototypes are spread out on purpose, which biases Hopkins
        toward 0.5, so svat and bigvat probe the data, not their sample."""
        n = X.shape[0]
        if n <= cap:
            return X.float()
        idx = np.sort(meta.host_rng(SALT_HOPKINS).choice(n, cap,
                                                         replace=False))
        return X.index_select(0, torch.as_tensor(idx, device=X.device)).float()

    def _assess_one(self, rstar: torch.Tensor, X: torch.Tensor,
                    generator: torch.Generator, meta: ResultMeta,
                    batch_index: int | None) -> TendencyReport:
        """Score one (rstar, X) pair: Hopkins + block structure."""
        score, k_est = core.block_structure_score(rstar)
        score = float(score)
        if meta.metric == "precomputed":
            # no point coordinates to probe — Hopkins is undefined
            h, clustered = float("nan"), score > 0.3
        else:
            Xh = self._hopkins_subsample(X, meta)
            h = float(core.hopkins(Xh, generator))
            clustered = h > 0.75 and score > 0.3
        return TendencyReport(method=meta.method, metric=meta.metric,
                              n=meta.n, hopkins=h, block_score=score,
                              k_est=int(k_est), clustered=bool(clustered),
                              batch_index=batch_index)

    def assess(self, generator: torch.Generator | None = None):
        """Machine-checkable tendency report: Hopkins + block structure.

        Returns one ``TendencyReport`` after ``fit`` and a list of b of them
        after ``fit_many``, with ``batch_index`` 0..b-1.

        Args:
          generator: source of the Hopkins probes, on the fit's device;
            None derives one from the fit's seed (``meta.generator``), for
            lane i of a batched fit its own from (seed, salt, i).  A given
            generator serves the lanes in turn.
        """
        res = self._require_fit()
        meta = res.meta
        with device_scope(res.rstar.device):
            if meta.batch is None:
                if generator is None:
                    generator = meta.generator(SALT_ASSESS)
                return self._assess_one(res.rstar, self._X, generator, meta,
                                        None)
            return [self._assess_one(
                res.rstar[i], None if self._X is None else self._X[i],
                generator if generator is not None
                else meta.generator(SALT_ASSESS, i), meta, i)
                for i in range(meta.batch)]


def assess_tendency(X, **kwargs) -> TendencyReport:
    """One-shot convenience: FastVAT(**kwargs).fit(X).assess()."""
    return FastVAT(**kwargs).fit(X).assess()

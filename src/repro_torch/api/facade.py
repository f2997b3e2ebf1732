"""FastVAT — the port's front door, on PyTorch and the H100.

The same surface as ``repro.FastVAT`` for the rungs ported so far:

  n <= SMALL_N  (2_048)   exact ``vat``      — O(n^2) matrix fits easily
  n <= MEDIUM_N (50_000)  exact ``flashvat`` — matrix-free, persistent
                                               Prim kernel, banded render
  larger                  ``approx``         — kNN-graph Borůvka MST
                                               (kNN kernel), banded render;
                                               error on ``meta.approx``

plus the opt-in ``ivat`` rung.  The fit runs on ``device`` (default
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
from repro_torch.api.validation import validate_dissimilarity, validate_points
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


class FastVAT:
    """Facade over the registered rungs with auto-selection.

    Parameters
    ----------
    method:    "auto" or any name in ``registry.methods()``; "auto" picks
               by n at fit time.  A rung of the reference that is not
               ported yet raises ``NotImplementedError``.
    metric:    "euclidean" | "sqeuclidean" | "manhattan" | "cosine", or
               "precomputed" to pass ``fit`` an (n, n) matrix directly.
    seed:      the single seed every sampling path (device and host side)
               derives from — see ``ResultMeta``.
    sample_size: m, the representatives the banded render of flashvat and
               approx draws (its image and ``rstar`` are (m, m)).
    turbo:     flashvat's traversal engine — None (default) or True the
               persistent kernel, False the stepwise engine (one fused step
               kernel per vertex); the same ordering either way.
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
                 sample_size: int = 256, turbo: bool | None = None,
                 knn_k: int = 15, seed: int = 0, validate: bool = True,
                 numerics="auto", device="cuda"):
        if method in registry.UNPORTED:
            raise registry.not_ported(method)
        methods = registry.methods()
        if method not in methods:
            raise ValueError(f"method must be one of {methods}, "
                             f"got {method!r}")
        validate_metric(metric)
        self.method = method
        self.metric = metric
        self.sample_size = sample_size
        self.turbo = turbo
        self.knn_k = knn_k
        self.seed = seed
        self.validate = validate
        self.numerics = as_policy(numerics)
        self.device = device
        self.method_resolved: str | None = None
        self.result: TendencyResult | None = None
        self._X: torch.Tensor | None = None

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

    def fit(self, X) -> "FastVAT":
        """Run the resolved rung on one dataset.

        Args:
          X: (n, d) array-like of points (numpy, or a tensor on any
            device), or — with ``metric="precomputed"`` — an (n, n)
            dissimilarity matrix (square, symmetric, zero diagonal).

        Returns:
          self; ``self.result`` is the rung's ``TendencyResult``.
        """
        dev = _device(self.device)
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        precomputed = self.metric == "precomputed"
        num_report = None
        if precomputed:
            if self.validate:
                validate_dissimilarity(X)
            data = torch.tensor(as_dissimilarity(X), device=dev)
        else:
            if self.validate:
                validate_points(X, metric=self.metric)
            Xr, num_report = resolve_numerics(X, metric=self.metric,
                                              policy=self.numerics)
            data = torch.tensor(Xr, device=dev)
            if num_report.dtype == "bf16":  # exact: Xr is bf16-quantized
                data = data.to(torch.bfloat16)
        n = int(data.shape[0])
        method = (self.method if self.method != "auto"
                  else select_method(n, precomputed=precomputed))
        rung = registry.get_rung(method)
        if precomputed and not rung.supports_precomputed:
            raise ValueError(f"method {method!r} does not accept "
                             "metric='precomputed'")
        meta = ResultMeta(method=method, metric=self.metric, n=n,
                          seed=self.seed, device=str(dev),
                          sample_size=self.sample_size, numerics=num_report)
        with device_scope(dev):
            self.result = rung.fit(data, meta, RungOptions(
                sample_size=self.sample_size, turbo=self.turbo,
                knn_k=self.knn_k,
                num_form=(num_report.form if num_report is not None
                          else "gram")))
        self.method_resolved = method
        self._X = data
        return self

    # --------------------------------------------------------- queries ----

    def _require_fit(self) -> TendencyResult:
        if self.result is None:
            raise RuntimeError("call fit(X) first")
        return self.result

    def order(self) -> np.ndarray:
        """VAT ordering of all n points, as a host array."""
        return self._require_fit().order.cpu().numpy()

    def sample_indices(self) -> np.ndarray | None:
        """Dataset rows of the representatives (flashvat), else None."""
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
        Hopkins statistic, as f32; the rows come from ``meta.host_rng``."""
        n = X.shape[0]
        if n <= cap:
            return X.float()
        idx = np.sort(meta.host_rng(SALT_HOPKINS).choice(n, cap,
                                                         replace=False))
        return X.index_select(0, torch.as_tensor(idx, device=X.device)).float()

    def assess(self, generator: torch.Generator | None = None
               ) -> TendencyReport:
        """Machine-checkable tendency report: Hopkins + block structure.

        Args:
          generator: source of the Hopkins probes, on the fit's device;
            None derives one from the fit's seed (``meta.generator``).
        """
        res = self._require_fit()
        meta = res.meta
        with device_scope(res.rstar.device):
            score, k_est = core.block_structure_score(res.rstar)
            score = float(score)
            if meta.metric == "precomputed":
                # no point coordinates to probe — Hopkins is undefined
                h, clustered = float("nan"), score > 0.3
            else:
                if generator is None:
                    generator = meta.generator(SALT_ASSESS)
                Xh = self._hopkins_subsample(self._X, meta)
                h = float(core.hopkins(Xh, generator))
                clustered = h > 0.75 and score > 0.3
        return TendencyReport(method=meta.method, metric=meta.metric,
                              n=meta.n, hopkins=h, block_score=score,
                              k_est=int(k_est), clustered=bool(clustered))


def assess_tendency(X, **kwargs) -> TendencyReport:
    """One-shot convenience: FastVAT(**kwargs).fit(X).assess()."""
    return FastVAT(**kwargs).fit(X).assess()

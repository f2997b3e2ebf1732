"""Streaming VAT — incremental cluster-tendency monitoring, on PyTorch.

As in ``repro/core/streaming.py``: the stream holds a maximin *reservoir*
of at most ``cap`` points (farthest-point thinning, the geometry sVAT
keeps).  Each arriving point is absorbed into its nearest slot's running
mean when it lies within the thinning radius (the reservoir's least
nearest-neighbour distance), and otherwise evicts the point whose nearest
neighbour is closest.  The reservoir and its absorb/evict rules are host
numpy, verbatim from the reference, so the reservoir is the reference's
bit for bit.

``order()``, ``image()`` and ``tendency()`` run the batch VAT of the
reservoir (``core.vat``: the pairwise and Prim kernels on the card) on the
stream's device each time the reservoir changed, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hopkins import hopkins
from repro_torch.core.vat import VATResult, block_structure_score
from repro_torch.core.vat import vat as batch_vat
from repro_torch.kernels.ref import check_metric


def _np_dissim_to_point(P: np.ndarray, x: np.ndarray,
                        metric: str) -> np.ndarray:
    """Host-side ``kernels.ref.row_dissim_ref`` twin: dissimilarity of
    every reservoir row to one point, in the stream's metric (the
    reference's formulas, numpy on the host: these O(cap) probes cost less
    there than a launch)."""
    diff = P - x
    if metric == "euclidean":
        return np.sqrt(np.maximum(np.sum(diff * diff, axis=-1), 0.0))
    if metric == "sqeuclidean":
        return np.sum(diff * diff, axis=-1)
    if metric == "manhattan":
        return np.sum(np.abs(diff), axis=-1)
    # cosine
    norms = np.sqrt(np.sum(P * P, axis=-1))
    nx = np.sqrt(np.sum(x * x))
    denom = np.maximum(norms * nx, 1e-12)
    return np.clip(1.0 - (P @ x) / denom, 0.0, 2.0)


def _np_pairwise(P: np.ndarray, metric: str) -> np.ndarray:
    """Host-side all-pairs twin of ``kernels.ref.pairwise_dissim_ref``, one
    vectorized numpy expression per metric (``_nn_dists`` runs once per
    streamed point)."""
    if metric in ("euclidean", "sqeuclidean"):
        d2 = np.sum((P[:, None] - P[None]) ** 2, axis=-1)
        return np.sqrt(np.maximum(d2, 0.0)) if metric == "euclidean" else d2
    if metric == "manhattan":
        return np.sum(np.abs(P[:, None] - P[None]), axis=-1)
    # cosine
    norms = np.sqrt(np.sum(P * P, axis=-1))
    denom = np.maximum(norms[:, None] * norms[None, :], 1e-12)
    return np.clip(1.0 - (P @ P.T) / denom, 0.0, 2.0)


class StreamingVAT:
    """Online cluster-tendency monitor with bounded memory.

    Example::

        sv = StreamingVAT(cap=256, d=8)
        for chunk in stream:
            sv.update(chunk)
        img, order = sv.image(), sv.order()

    ``metric`` threads end to end: the reservoir's absorb/evict geometry
    and the VAT queries run in the chosen dissimilarity.  The absorb step
    folds into a coordinate running mean, for every metric.

    ``validate`` (default True) refuses, under a cosine stream, a whole
    chunk holding a zero-norm point with ``InvalidInput(reason=
    "zero_norm")`` before any of it is inserted; ``validate=False`` keeps
    the eps-guard semantics.

    ``device`` is where the queries run: "cuda" (default) launches the
    CUDA kernels, "cpu" runs their plain versions.  Without a GPU the
    default device raises ``RuntimeError`` here rather than carry on on the
    CPU.
    """

    def __init__(self, cap: int, d: int, *, metric: str = "euclidean",
                 validate: bool = True, device="cuda"):
        check_metric(metric)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"StreamingVAT(device={str(device)!r}) needs a CUDA GPU and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels")
        self.cap = cap
        self.d = d
        self.metric = metric
        self.validate = validate
        self.pts = np.empty((0, d), np.float32)
        self.counts = np.empty((0,), np.int64)   # absorbed multiplicity
        self.n_seen = 0
        self._dirty = True
        self._cached: VATResult | None = None

    # ------------------------------------------------------- ingest ----

    def update(self, X) -> None:
        """Ingest a chunk of streaming points.

        Args:
          X: (m, d) array-like (or anything reshapeable to it) — the next
            m points of the stream, inserted one at a time into the
            reservoir.

        Raises:
          InvalidInput: with ``validate=True`` and ``metric="cosine"``, a
            zero-norm point in the chunk (the whole chunk is refused
            before any insertion).
        """
        X = np.asarray(X, np.float32).reshape(-1, self.d)
        if self.validate and self.metric == "cosine":
            norms = np.einsum("nd,nd->n", np.asarray(X, np.float64),
                              np.asarray(X, np.float64))
            zero = np.flatnonzero(norms == 0.0)
            if zero.size:
                # lazy import: core must not pull the api package in at
                # module-import time (the facade imports core)
                from repro_torch.api.validation import InvalidInput
                raise InvalidInput(
                    "zero_norm",
                    f"streamed chunk has zero-norm rows {zero.tolist()}; "
                    "cosine dissimilarity is undefined for them — drop "
                    "the rows or construct StreamingVAT(validate=False) "
                    "to keep the eps-guard semantics")
        for x in X:
            self._insert(x)
        self.n_seen += len(X)
        self._dirty = True

    def _insert(self, x: np.ndarray) -> None:
        if len(self.pts) < self.cap:
            self.pts = np.concatenate([self.pts, x[None]])
            self.counts = np.concatenate([self.counts, [1]])
            return
        dist = _np_dissim_to_point(self.pts, x, self.metric)
        j = int(np.argmin(dist))
        # thinning radius: current minimum pairwise separation
        radius = self._min_sep()
        if dist[j] <= radius:
            # absorb into the slot's running mean, weighted by the OLD
            # multiplicity: mean_new = (mean * c + x) / (c + 1)
            c = self.counts[j]
            self.pts[j] = (self.pts[j] * c + x) / (c + 1)
            self.counts[j] = c + 1
            return
        # evict the most redundant reservoir point (smallest NN distance)
        nn = self._nn_dists()
        k = int(np.argmin(nn))
        self.pts[k] = x
        self.counts[k] = 1

    def _nn_dists(self) -> np.ndarray:
        D = _np_pairwise(self.pts, self.metric)
        np.fill_diagonal(D, np.inf)
        return D.min(axis=1)

    def _min_sep(self) -> float:
        return float(self._nn_dists().min())

    # ------------------------------------------------------ queries ----

    def _points(self) -> torch.Tensor:
        return torch.tensor(self.pts, device=self.device)

    def _vat(self) -> VATResult:
        if self._dirty or self._cached is None:
            self._cached = batch_vat(self._points(), metric=self.metric)
            self._dirty = False
        return self._cached

    def order(self) -> np.ndarray:
        """Exact VAT ordering of the current reservoir: (len(pts),) int64."""
        return self._vat().order.cpu().numpy()

    def image(self) -> np.ndarray:
        """Reordered dissimilarity image of the reservoir: (len(pts),)^2."""
        return self._vat().rstar.cpu().numpy()

    def tendency(self, generator: torch.Generator | None = None):
        """Tendency snapshot of the current reservoir.

        Args:
          generator: source of the Hopkins probes, on the stream's device;
            None seeds one with ``n_seen``, so repeated calls between
            updates agree (the reference's ``PRNGKey(n_seen)``).

        Returns:
          (hopkins: float, block_score: float, k_est: int).
        """
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.n_seen)
        score, k = block_structure_score(self._vat().rstar)
        return (float(hopkins(self._points(), generator)), float(score),
                int(k))

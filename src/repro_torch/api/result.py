"""The uniform result types the port's rungs return.

``TendencyResult`` is the one shape the public API speaks: the vat and
ivat rungs both return it, so downstream code reads ``result.order`` /
``result.image()`` without knowing which rung produced it.  Its array
fields are tensors on the device the fit ran on.

``ResultMeta`` is the single seed source: every sampling path — on the
device (the Hopkins probes, through ``generator(salt)``, per lane of a
batched fit ``generator(salt, lane)``) and on the host (the Hopkins
subsample, through ``host_rng(salt)``) — derives from ``meta.seed``, which
makes a fit reproducible from its meta alone.

``TendencyReport`` is ``assess()``'s stable shape, with dict-like access.

>>> from repro_torch.api.result import TendencyReport
>>> rep = TendencyReport(method="vat", metric="euclidean", n=100,
...                      hopkins=0.9, block_score=0.8, k_est=3,
...                      clustered=True)
>>> rep["k_est"], rep.k_est            # dict-like and attribute access
(3, 3)
>>> sorted(rep.keys())[:3]
['batch_index', 'block_score', 'clustered']
>>> dict(rep)["batch_index"] is None   # solo fit: key present, value None
True
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Mapping
from typing import Any, ClassVar

import numpy as np
import torch

from repro_torch.core.approx_mst import ApproxStats
from repro_torch.core.bigvat import expand_image
from repro_torch.core.ivat import ivat_from_vat
from repro_torch.numerics.condition import NumericsReport

# Salts for deriving independent streams from the one seed on ResultMeta.
# Fit-time sampling, assessment (Hopkins probes) and the host-side Hopkins
# subsample each get their own stream so no two consumers of the seed are
# correlated.
SALT_FIT = 0
SALT_ASSESS = 1
SALT_HOPKINS = 2


def device_scope(device):
    """Make a CUDA ``device`` the current one while the kernels run (they
    launch on the current device's current stream), so a fit on "cuda:1"
    works whatever device is current; a no-op for the CPU."""
    dev = torch.device(device)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(frozen=True)
class ResultMeta:
    """Static metadata of a fit.

    Attributes:
      method: resolved rung name, e.g. "vat".
      metric: dissimilarity metric the fit used ("precomputed" means the
        caller handed the matrix in).
      n: points per dataset.
      batch: lanes of a ``fit_many`` (the result's arrays then carry a
        leading batch axis); None for a solo fit.
      seed: the single seed every sampling path derives from.
      device: the device the fit ran on ("cuda", "cuda:0", "cpu").  On a
        CUDA device every kernel of the fit was the CUDA kernel; on the
        CPU every one was its plain PyTorch version.
      sample_size: representatives the banded render draws (the m of
        flashvat and approx); the facade's ``sample_size``.
      approx: the approx rung's error report (``core.ApproxStats``: k,
        kNN mode, Borůvka passes, components before repair, repaired edges
        and their weight, tree weight); None for every other rung.
      encoder: fingerprint of the encoder that produced the fitted
        activations (the ``embed`` rung, ``FastVAT.fit(X, encoder=…)`` /
        ``fit_embeddings``); None when the fit ran on raw input points.
      numerics: the numerics shield's plan for this fit
        (``numerics.NumericsReport``): condition estimate κ, policy mode,
        tile form, storage dtype, whether the conditioning transform ran,
        and counted fallbacks.  None for precomputed input.
    """

    method: str
    metric: str = "euclidean"
    n: int = 0
    batch: int | None = None
    seed: int = 0
    device: str = "cuda"
    sample_size: int | None = None
    approx: ApproxStats | None = None
    encoder: str | None = None
    numerics: NumericsReport | None = None

    def generator(self, salt: int = SALT_FIT,
                  lane: int | None = None) -> torch.Generator:
        """``torch.Generator`` on the fit's device, seeded from
        (seed, salt) — the port's counterpart of the reference's
        ``jax_key(salt)`` — or, for lane i of a batched fit, from
        (seed, salt, i), where the reference splits its key b ways (JAX's
        split draws cannot be reproduced in torch, so the lanes' streams
        are derived, not split)."""
        entropy = [self.seed, salt] + ([] if lane is None else [lane])
        seed = int(np.random.SeedSequence(entropy)
                   .generate_state(1, np.uint64)[0] >> np.uint64(1))
        return torch.Generator(device=self.device).manual_seed(seed)

    def host_rng(self, salt: int = SALT_FIT) -> np.random.Generator:
        """numpy Generator for host-side sampling, same seed source.

        Uses ``SeedSequence([seed, salt])``, exactly as the reference does.
        """
        return np.random.default_rng(np.random.SeedSequence([self.seed, salt]))


@dataclasses.dataclass(frozen=True)
class TendencyResult:
    """What every rung returns: ordering + images, one shape.

    Attributes:
      order: (n,) int64 VAT ordering of all n points (of the s sampled
        points for svat); (b, n) after
        ``fit_many``, as every array below gains a leading batch axis
        (``group_sizes`` excepted: one band layout serves every lane).
      rstar: reordered dissimilarity image — (n, n) for vat/ivat, the
        (m, m) matrix of the representatives in band order for flashvat
        and approx, the (s, s) VAT image of the maximin sample for svat and
        dvat.
      ivat_image: geodesic (iVAT) image where the rung computed one (ivat,
        flashvat, approx), else None; ``image(use_ivat=True)`` derives it
        on demand from ``rstar`` when absent.
      sample_idx: dataset rows of the representatives (flashvat, approx)
        or of the maximin sample (svat, dvat), else None.
      extension_labels: (n,) band id of every point (flashvat, approx),
        else None.
      meta: static fit metadata (method, metric, n, seed, device, ...).
      group_sizes: (m,) points per band of a banded render (flashvat,
        approx); None for vat/ivat.
    """

    order: torch.Tensor
    rstar: torch.Tensor
    ivat_image: torch.Tensor | None
    sample_idx: torch.Tensor | None
    extension_labels: torch.Tensor | None
    meta: ResultMeta
    group_sizes: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.meta.n

    @property
    def is_batched(self) -> bool:
        return self.meta.batch is not None

    @classmethod
    def from_arrays(cls, order, rstar, ivat_image, meta: ResultMeta, *,
                    sample_idx=None, extension_labels=None,
                    group_sizes=None) -> "TendencyResult":
        """A result from host arrays — e.g. the fields of a reference
        ``TendencyResult`` as numpy arrays — placed on ``meta.device``, so
        ``image()`` and ``assess()`` can be run on a fit made elsewhere.  A
        batched fit's arrays come with their batch axis and ``meta.batch``
        set."""
        def put(a, dtype):
            return None if a is None else torch.tensor(
                np.asarray(a), dtype=dtype, device=meta.device)
        return cls(order=put(order, torch.int64),
                   rstar=put(rstar, torch.float32),
                   ivat_image=put(ivat_image, torch.float32),
                   sample_idx=put(sample_idx, torch.int64),
                   extension_labels=put(extension_labels, torch.int64),
                   group_sizes=put(group_sizes, torch.int64), meta=meta)

    def image(self, *, resolution: int = 256,
              use_ivat: bool | None = None) -> np.ndarray:
        """The reordered dissimilarity image (the thing you look at).

        The geodesic image is used when one was computed
        (``use_ivat=None``) or demanded (``use_ivat=True`` — derived on
        demand from ``rstar`` if the rung didn't build one);
        ``use_ivat=False`` forces the plain reordered dissimilarities.
        Results carrying ``group_sizes`` are expanded to ``resolution``
        pixels by group size; everything else returns the image at its
        native size, as a host numpy array.  A batched result gives the
        (b, ·, ·) stack of its lanes' images.
        """
        want_ivat = (self.ivat_image is not None if use_ivat is None
                     else bool(use_ivat))
        if want_ivat:
            if self.ivat_image is not None:
                base = self.ivat_image
            else:
                with device_scope(self.rstar.device):
                    base = ivat_from_vat(self.rstar)
        else:
            base = self.rstar
        base = base.cpu().numpy()
        if self.group_sizes is not None:
            return expand_image(base, self.group_sizes.cpu().numpy(),
                                resolution)
        return base


@dataclasses.dataclass(frozen=True, eq=False)
class TendencyReport(Mapping):
    """``assess()``'s stable shape.

    A frozen dataclass that also satisfies the Mapping protocol
    (``rep["k_est"]``, ``dict(rep)``, ``rep.get("hopkins")``).  Equality
    treats NaN hopkins values (the precomputed-metric case) as equal.

    Attributes:
      method: resolved rung name.
      metric: dissimilarity metric of the fit.
      n: points per dataset.
      hopkins: Hopkins statistic (H > 0.75 => significant structure);
        NaN when metric="precomputed" (no point coordinates to probe).
      block_score: [0, 1] diagonal-block contrast of the VAT image.
      k_est: estimated cluster count from super-diagonal cuts.
      clustered: the combined verdict (hopkins and block_score bars;
        block_score alone when hopkins is NaN).
      batch_index: dataset index of a batched fit; None for solo fits.
    """

    method: str
    metric: str
    n: int
    hopkins: float
    block_score: float
    k_est: int
    clustered: bool
    batch_index: int | None = None

    _KEYS: ClassVar[tuple[str, ...]] = (
        "method", "metric", "n", "hopkins", "block_score", "k_est",
        "clustered", "batch_index")

    def __getitem__(self, key: str) -> Any:
        if key in self._KEYS:
            return getattr(self, key)
        raise KeyError(key)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __eq__(self, other):
        if not isinstance(other, TendencyReport):
            return NotImplemented
        return all(_field_eq(getattr(self, k), getattr(other, k))
                   for k in self._KEYS)

    def as_dict(self) -> dict:
        """Plain-dict copy (e.g. for json.dumps)."""
        return {k: getattr(self, k) for k in self._KEYS}


def _field_eq(a, b) -> bool:
    """Equality where NaN == NaN (hopkins is NaN for precomputed fits)."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b

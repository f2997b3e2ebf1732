"""Big-VAT — clusiVAT-style cluster tendency for n >= 1e5, on PyTorch.

As in ``repro/core/bigvat.py``, without any (n, n) array:

  1. **sample**  — s maximin "distinguished" prototypes (O(n s) time,
     O(n) memory),
  2. **assess**  — exact VAT + iVAT on the (s, s) sample matrix (steps 1+2
     together are ``core.svat.svat_from``, reused here),
  3. **extend**  — a tiled nearest-prototype pass that streams X through
     ``kernels.ops.pairwise_dist`` (the CUDA kernel on the card) in row
     blocks: each (block, s) tile is reduced on the spot to every row's
     nearest prototype and its distance, written into (n,) tensors on the
     device.  Peak intermediate O(block * s), no host sync a block.

The full-data ordering groups points by their prototype's position in the
sample VAT order (nearest-prototype extension), and ``smoothed_image``
renders the aggregated VAT image where each prototype's row/column band is
as wide as its group — the clusiVAT "smoothed" picture of all n points.

X may be a tensor, a numpy array or an ``np.memmap``: ``bigvat`` copies it
to the device once for the sampling pass (as the reference does), and
``nearest_prototype_assign`` called on a host array copies it one row
block at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ivat import ivat_from_vat
from repro_torch.core.svat import SVATResult, svat_from
from repro_torch.kernels import ops as kops

DEFAULT_SAMPLE = 256
DEFAULT_BLOCK = 4096


class BigVATResult(NamedTuple):
    sample: SVATResult           # exact VAT on the s maximin prototypes
    ivat: torch.Tensor | None    # (s, s) iVAT image, or None
    labels: torch.Tensor         # (n,) int64 nearest prototype (sample pos)
    proto_dist: torch.Tensor     # (n,) f32 distance to that prototype
    order: torch.Tensor          # (n,) int64 full-data ordering (bigvat())
    group_sizes: torch.Tensor    # (s,) int64 group counts, sample-VAT order

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    @property
    def s(self) -> int:
        return int(self.group_sizes.shape[0])


def nearest_prototype_assign(X, prototypes: torch.Tensor, *,
                             block: int = DEFAULT_BLOCK,
                             metric: str = "euclidean"):
    """Tiled nearest-prototype pass.

    Args:
      X: (n, d) tensor on the prototypes' device, or a host array-like that
        slices by rows (np.memmap included), copied one block at a time.
      prototypes: (s, d) float tensor — the maximin sample; its device is
        where the pass runs.
      block: rows per streamed tile.
      metric: one of ``kernels.ref.METRICS``.

    Returns:
      (labels (n,) int64 nearest-prototype ids, the first index among equal
      distances; dists (n,) f32 distances to that prototype), on the
      prototypes' device.  Each block's (block, s) tile from
      ``kernels.ops.pairwise_dist`` is reduced into these tensors in place,
      so the host never waits on the card inside the loop.
    """
    dev = prototypes.device
    n = X.shape[0]
    labels = torch.empty(n, dtype=torch.int64, device=dev)
    dists = torch.empty(n, dtype=torch.float32, device=dev)
    for start in range(0, n, block):
        stop = min(start + block, n)
        blk = X[start:stop]
        if not isinstance(blk, torch.Tensor):
            blk = torch.tensor(np.asarray(blk, np.float32), device=dev)
        D = kops.pairwise_dist(blk, prototypes, metric=metric)
        torch.min(D, dim=1, out=(dists[start:stop], labels[start:stop]))
    return labels, dists


def _device_points(X) -> torch.Tensor:
    """X as an f32 tensor: a tensor stays on its device, a host array goes
    to "cuda"."""
    if isinstance(X, torch.Tensor):
        return X.float()
    return torch.tensor(np.asarray(X, np.float32), device="cuda")


def bigvat_from(X, i0, *, s: int = DEFAULT_SAMPLE,
                block: int = DEFAULT_BLOCK, compute_ivat: bool = True,
                metric: str = "euclidean") -> BigVATResult:
    """clusiVAT-style big-data VAT of X (n, d) from the maximin start i0.

    Args:
      X: (n, d) tensor, which stays on its device, or a host array-like
        (np.memmap ok) copied to "cuda" once.
      i0: the first maximin pick (int or integer tensor).
      s: prototype count (clamped to n); block: rows per extension tile.
      compute_ivat: also build the (s, s) geodesic image.
      metric: one of ``kernels.ref.METRICS``, for the sampling, the sample
        VAT and the extension pass.

    Returns:
      BigVATResult.  ``order`` lists all n points grouped by their
      prototype's position in the sample VAT order, and within a group by
      distance to the prototype, ties in index order (the reference's
      ``lexsort``).
    """
    Xj = _device_points(X)
    s = min(s, Xj.shape[0])
    sample = svat_from(Xj, i0, s=s, metric=metric)
    res = sample.vat
    iv = ivat_from_vat(res.rstar) if compute_ivat else None
    labels, proto_dist = nearest_prototype_assign(
        Xj, Xj.index_select(0, sample.sample_idx), block=block,
        metric=metric)
    # rank[p] = position of prototype p in the sample VAT order
    rank = torch.empty(s, dtype=torch.int64, device=Xj.device)
    rank[res.order] = torch.arange(s, device=Xj.device)
    # lexsort((proto_dist, rank[labels])): two stable sorts, the secondary
    # key first, so ties keep index order
    by_dist = torch.sort(proto_dist, stable=True).indices
    by_rank = torch.sort(rank[labels].index_select(0, by_dist),
                         stable=True).indices
    order = by_dist.index_select(0, by_rank)
    group_sizes = torch.bincount(labels, minlength=s).index_select(
        0, res.order)
    return BigVATResult(sample=sample, ivat=iv, labels=labels,
                        proto_dist=proto_dist, order=order,
                        group_sizes=group_sizes)


def bigvat(X, generator: torch.Generator | None = None, *,
           s: int = DEFAULT_SAMPLE, block: int = DEFAULT_BLOCK,
           compute_ivat: bool = True,
           metric: str = "euclidean") -> BigVATResult:
    """``bigvat_from`` a maximin start drawn uniformly from the n rows with
    ``generator`` (on the points' device; None: one seeded with 0, the
    reference's ``PRNGKey(0)``), as ``core.svat.svat`` draws it."""
    Xj = _device_points(X)
    if generator is None:
        generator = torch.Generator(device=Xj.device).manual_seed(0)
    i0 = torch.randint(0, Xj.shape[0], (), generator=generator,
                       device=Xj.device)
    return bigvat_from(Xj, i0, s=s, block=block, compute_ivat=compute_ivat,
                       metric=metric)


def expand_image(base, group_sizes, resolution: int = 256) -> np.ndarray:
    """Expand an (s, s) sample image to ``resolution`` pixels by group size.

    Args:
      base: (s, s) array — sample VAT/iVAT image in sample-VAT order; a
        leading batch axis (b, s, s) passes through.
      group_sizes: (s,) int — per-prototype group counts, in the same
        order as ``base``'s rows.
      resolution: output image edge in pixels.

    Returns:
      (resolution, resolution) float32 numpy image where each prototype's
      row/column band spans pixels proportional to its group size — the
      picture a full n x n VAT image would show, rendered from the
      (s, s) sample alone.  O(resolution^2) memory, independent of n.
    """
    base = np.asarray(base)
    sizes = np.asarray(group_sizes, np.int64)
    edges = np.cumsum(sizes)                     # group boundaries in [0, n]
    n = int(edges[-1])
    pix = (np.arange(resolution) + 0.5) * n / resolution
    g = np.searchsorted(edges, pix, side="right")
    g = np.minimum(g, len(sizes) - 1)
    return base[..., g[:, None], g[None, :]]


def smoothed_image(result: BigVATResult, resolution: int = 256,
                   *, use_ivat: bool = False) -> np.ndarray:
    """Aggregated "smoothed" VAT image of all n points at a fixed
    resolution: ``expand_image`` of the sample's rstar (or, with
    ``use_ivat``, its iVAT image; ValueError when the result was built
    with compute_ivat=False).  O(resolution^2) memory, independent of n.
    """
    if use_ivat and result.ivat is None:
        raise ValueError("this BigVATResult was built with compute_ivat="
                         "False; no iVAT image to render")
    base = result.ivat if use_ivat else result.sample.vat.rstar
    return expand_image(base.cpu().numpy(), result.group_sizes.cpu().numpy(),
                        resolution)

"""Clustering baselines the paper compares VAT against (Table 3), on
PyTorch.

As in ``repro/core/cluster.py``: K-Means (Lloyd, greedy maximin seeding)
and DBSCAN, both dense — every distance comes from
``kernels.ops.pairwise_dist`` (the CUDA kernel on the card), and DBSCAN's
cluster assignment is a vectorized min-label propagation, not a BFS.  The
one-hot product, the label sweeps and the SVD of ``pca`` are plain torch
ops, as they are plain XLA in the reference; their products run in full
f32 (``kernels.ref.full_f32``) whatever the caller set for TF32.  ARI is
host numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.svat import maximin_sample_from
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import full_f32


def kmeans_from(X: torch.Tensor, i0, *, k: int, iters: int = 50):
    """Lloyd's algorithm from the greedy maximin seeding that starts at i0.

    Args:
      X: (n, d) float — data points.
      i0: the first maximin pick (int or integer tensor).
      k: number of clusters.
      iters: Lloyd iterations.

    Returns:
      (labels (n,) int64, centers (k, d) f32, inertia: 0-d f32 sum of the
      squared distances to the assigned centre).  An empty cluster keeps
      its centre.  No step reads a value back to the host.
    """
    centers = X.index_select(0, maximin_sample_from(X, k, i0))
    for _ in range(iters):
        lab = torch.argmin(kops.pairwise_dist(X, centers), dim=1)
        oh = torch.nn.functional.one_hot(lab, k).to(X.dtype)      # (n, k)
        counts = oh.sum(dim=0)                                     # (k,)
        with full_f32():
            new = (oh.T @ X) / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    dist = kops.pairwise_dist(X, centers)
    mind, labels = torch.min(dist, dim=1)
    return labels, centers, torch.sum(mind ** 2)


def kmeans(X: torch.Tensor, generator: torch.Generator, *, k: int,
           iters: int = 50):
    """``kmeans_from`` a seeding start drawn uniformly from the n rows with
    ``generator`` (on X's device), as ``core.svat.maximin_sample`` draws
    it."""
    i0 = torch.randint(0, X.shape[0], (), generator=generator,
                       device=X.device)
    return kmeans_from(X, i0, k=k, iters=iters)


def _dbscan(X: torch.Tensor, eps: float, min_pts: int):
    """DBSCAN's labels and the number of label sweeps it ran (the last one
    changed nothing)."""
    n = X.shape[0]
    R = kops.pairwise_dist(X)
    nbr = R <= eps                                   # (n, n), self included
    del R
    core = torch.sum(nbr, dim=1) >= min_pts
    big = torch.tensor(n, dtype=torch.int32, device=X.device)
    labels = torch.where(core, torch.arange(n, dtype=torch.int32,
                                            device=X.device), big)
    core_nbr = nbr & core[None, :]                   # edges into core points
    del nbr

    def least_core_label(labels):
        return torch.amin(torch.where(core_nbr, labels[None, :], big), dim=1)

    sweeps = 0
    while True:   # to the fixpoint, one host sync a sweep
        best = least_core_label(labels)
        new = torch.where(core, torch.minimum(labels, best), labels)
        sweeps += 1
        if not bool(torch.any(new != labels)):
            break
        labels = new
    # border points join their least-labelled core neighbour; else noise
    border = least_core_label(labels)
    out = torch.where(core, labels, torch.where(border < big, border, -1))
    return out.long(), sweeps


def dbscan(X: torch.Tensor, *, eps: float, min_pts: int = 5) -> torch.Tensor:
    """Density-based clustering (DBSCAN), dense.

    Args:
      X: (n, d) float — data points.
      eps: neighbourhood radius.
      min_pts: core-point threshold, self included.

    Returns:
      (n,) int64 labels; -1 marks noise.  Label values are core-point
      indices (not compacted to 0..k-1) — feed them to
      ``adjusted_rand_index`` or np.unique for canonical ids.

    Connected components of the core-point graph come from min-label
    sweeps to a fixpoint (at most n of them, in practice the components'
    diameters): each core point takes the least label among its core
    neighbours.  Memory: the (n, n) matrix, then a boolean neighbour graph
    and an int32 candidate matrix a sweep.
    """
    return _dbscan(X, eps, min_pts)[0]


def _host_labels(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def adjusted_rand_index(a, b) -> float:
    """Adjusted Rand index between two labelings.

    Args:
      a, b: (n,) integer label vectors, numpy or tensors on any device
        (noise -1 treated as a label).

    Returns:
      float in [-1, 1]; 1 = identical partitions, ~0 = chance agreement.
    """
    a = _host_labels(a)
    b = _host_labels(b)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    C = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(C, (ai, bi), 1)
    comb = lambda x: x * (x - 1) // 2   # noqa: E731
    sum_ij = comb(C).sum()
    sum_a = comb(C.sum(1)).sum()
    sum_b = comb(C.sum(0)).sum()
    total = comb(len(a))
    exp = sum_a * sum_b / max(total, 1)
    mx = 0.5 * (sum_a + sum_b)
    if mx == exp:
        return 1.0
    return float((sum_ij - exp) / (mx - exp))


def pca(X: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Top-k principal components (the validation picture the paper uses).

    Args:
      X: (n, d) float — data points.
      k: number of components.

    Returns:
      (n, k) — X centred and projected onto the top-k principal directions
      (each direction's sign is the SVD's, so arbitrary).
    """
    Xc = X - torch.mean(X, dim=0)
    with full_f32():
        _, _, vt = torch.linalg.svd(Xc, full_matrices=False)
        return Xc @ vt[:k].T

"""Hopkins statistic — the paper's quantitative clusterability check.

H = sum(u) / (sum(u) + sum(w)) where u are nearest-neighbour distances of
m synthetic uniform points to the data and w are NN distances of m sampled
data points to the rest of the data.  H ~ 0.5 for uniform data; H > 0.75
indicates significant cluster structure (the threshold the paper uses).

The random draws come from a ``torch.Generator`` (``hopkins_draws``); the
statistic itself (``hopkins_from_draws``) takes the draws as arguments, so
the same probes can be handed to this port and to the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def probe_count(n: int, m: int = 0) -> int:
    """The probe count: ``m``, or max(8, min(n // 10, 256)) for 0; < n."""
    if m == 0:
        m = max(8, min(n // 10, 256))
    return min(m, n - 1)


def hopkins_draws(X: torch.Tensor, generator: torch.Generator, m: int):
    """(U (m, d) uniform in X's bounding box, idx (m,) distinct rows of X),
    drawn on X's device from ``generator``."""
    n, d = X.shape
    lo = torch.amin(X, dim=0)
    hi = torch.amax(X, dim=0)
    u01 = torch.rand((m, d), generator=generator, device=X.device,
                     dtype=X.dtype)
    U = lo + (hi - lo) * u01
    idx = torch.randperm(n, generator=generator, device=X.device)[:m]
    return U, idx


def hopkins_from_draws(X: torch.Tensor, U: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """The Hopkins statistic of X for given probes (0-d f32 tensor).

    Args:
      X: (n, d) float — data points.
      U: (m, d) float — uniform probes in X's bounding box.
      idx: (m,) int — distinct rows of X, the data probes.
    """
    m = U.shape[0]
    # u: NN distance from uniform points to the data
    u = torch.amin(kops.pairwise_dist(U, X), dim=1)
    # w: NN distance from sampled data points to the data minus themselves
    dw = kops.pairwise_dist(X.index_select(0, idx), X)
    dw[torch.arange(m, device=X.device), idx] = torch.inf
    w = torch.amin(dw, dim=1)
    return torch.sum(u) / (torch.sum(u) + torch.sum(w) + 1e-12)


def hopkins(X: torch.Tensor, generator: torch.Generator, *,
            m: int = 0) -> torch.Tensor:
    """Hopkins statistic of a dataset.

    Args:
      X: (n, d) float — data points.
      generator: ``torch.Generator`` on X's device, the source of the
        uniform probes and the data sample.
      m: probe count; 0 means max(8, min(n // 10, 256)).

    Returns:
      f32 0-d tensor H in (0, 1): ~0.5 for uniform data, > 0.75 indicates
      significant cluster structure (the paper's threshold).
    """
    U, idx = hopkins_draws(X, generator, probe_count(X.shape[0], m))
    return hopkins_from_draws(X, U, idx)

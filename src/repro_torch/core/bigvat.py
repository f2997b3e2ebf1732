"""The image expansion of the sampled rungs, ported for ``api/result.py``.

Only ``expand_image`` is here yet (host-side numpy, verbatim from
``repro/core/bigvat.py``); the bigvat rung itself is a later slice.
"""
from __future__ import annotations

import numpy as np


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

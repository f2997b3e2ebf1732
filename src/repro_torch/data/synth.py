"""The paper's seven evaluation datasets, generated deterministically.

The port's own copy of ``repro/data/synth.py`` (numpy only, verbatim), so
the port's evaluation and its tests draw the reference's points bit for
bit without importing it.

Sizes follow the paper (Iris 150x4, Mall 200x2-ish, Spotify 500x10,
synthetic sets ~1000 points).  Iris/Mall/Spotify have no bundled files in
this offline container, so structurally-matched surrogates are generated:
  * iris   — 3 anisotropic Gaussians in 4-D with one overlapping pair
             (mirrors setosa-separable / versicolor-virginica-overlap)
  * mall   — 5 customer segments in (income, spend) space
  * spotify— 500x10 weakly-structured audio-feature-like noise (the paper's
             point for this set is that VAT shows NO structure)
Each returns (X float32 (n,d), labels int32 (n,) or None).
"""
from __future__ import annotations

import numpy as np

_N = 1000  # synthetic dataset size, matches the paper's ~1k scale


def _blobs(rng, n=_N, spread=1.0):
    # well-separated triangle of isotropic Gaussians (sklearn-blobs style)
    centers = np.array([[0.0, 0.0], [10.0, 0.0], [5.0, 9.0]], np.float32)
    lab = rng.integers(0, 3, size=n)
    X = centers[lab] + rng.normal(scale=spread, size=(n, 2))
    return X.astype(np.float32), lab.astype(np.int32)


def make_dataset(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name == "iris":
        c = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3],
                      [6.6, 3.0, 5.6, 2.0]], np.float32)
        lab = np.repeat(np.arange(3), 50)
        X = c[lab] + rng.normal(scale=[0.35, 0.38, 0.17, 0.10],
                                size=(150, 4))
        return X.astype(np.float32), lab.astype(np.int32)
    if name == "mall":
        centers = np.array([[25, 80], [25, 20], [55, 50], [85, 80], [85, 15]],
                           np.float32)
        lab = rng.integers(0, 5, size=200)
        X = centers[lab] + rng.normal(scale=8.0, size=(200, 2))
        return X.astype(np.float32), lab.astype(np.int32)
    if name == "spotify":
        # 500 x 10 audio-feature-like matrix: strongly correlated features
        # (high Hopkins, like the paper's 0.87) but NO block structure —
        # the case where VAT visually overrides a misleading statistic
        A = rng.normal(size=(10, 10)) * (rng.random(10) ** 2)[None, :]
        base = rng.normal(size=(500, 10)) @ A
        return base.astype(np.float32), None
    if name == "blobs":
        return _blobs(rng)
    if name == "moons":
        n = _N
        t = rng.random(n) * np.pi
        half = rng.integers(0, 2, n)
        x = np.where(half == 0, np.cos(t), 1.0 - np.cos(t))
        y = np.where(half == 0, np.sin(t), 0.5 - np.sin(t))
        X = np.stack([x, y], 1) + rng.normal(scale=0.06, size=(n, 2))
        return X.astype(np.float32), half.astype(np.int32)
    if name == "circles":
        n = _N
        t = rng.random(n) * 2 * np.pi
        ring = rng.integers(0, 2, n)
        r = np.where(ring == 0, 1.0, 0.45)
        X = np.stack([r * np.cos(t), r * np.sin(t)], 1)
        X = X + rng.normal(scale=0.04, size=(n, 2))
        return X.astype(np.float32), ring.astype(np.int32)
    if name == "gmm":
        # overlapping gaussian mixture (the paper's "blurred diagonal" case)
        centers = np.array([[0, 0], [2.5, 0], [1.2, 2.0]], np.float32)
        lab = rng.integers(0, 3, size=_N)
        X = centers[lab] + rng.normal(scale=0.9, size=(_N, 2))
        return X.astype(np.float32), lab.astype(np.int32)
    raise KeyError(name)


DATASETS = ("iris", "mall", "spotify", "blobs", "moons", "circles", "gmm")


def make_big_blobs(n: int = 100_000, k: int = 5, d: int = 8, seed: int = 0,
                   scale: float = 1.5):
    """Well-separated Gaussian blobs at Big-VAT scale (n >> 1e4).

    The distribution of the reference's examples/bigvat_demo.py and of its
    benchmarks' table 4.
    Returns (X float32 (n, d), labels int32 (n,)).
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40.0, 40.0, size=(k, d)).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    X = centers[lab] + rng.normal(scale=scale, size=(n, d)).astype(np.float32)
    return X.astype(np.float32), lab.astype(np.int32)

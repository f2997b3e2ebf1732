"""t-SNE (exact O(n^2) variant), on PyTorch — the paper validates cluster
tendency with PCA and t-SNE beside VAT.

As in ``repro/core/tsne.py`` (van der Maaten & Hinton 2008): per-point
precisions by bisection to a target perplexity, symmetrized affinities,
KL gradient descent with early exaggeration and momentum.  The input
distances come from ``kernels.ops.pairwise_dist`` (the CUDA kernel on the
card); the softmax, the gradient and the updates are plain torch ops, as
they are plain XLA in the reference, and the gradient's product runs in
full f32 (``kernels.ref.full_f32``) whatever the caller set for TF32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import full_f32


def _cond_probs(D2: torch.Tensor, perplexity: float,
                iters: int = 32) -> torch.Tensor:
    """Row-wise conditional P_{j|i} at the target perplexity: ``iters``
    bisection steps on each row's precision β, the diagonal masked to -inf
    before the row softmax."""
    n = D2.shape[0]
    target = math.log(perplexity)
    eye = torch.eye(n, dtype=torch.bool, device=D2.device)

    def entropy_probs(beta):
        logits = (-D2 * beta[:, None]).masked_fill(eye, -torch.inf)
        P = torch.softmax(logits, dim=1)
        H = -torch.sum(P * torch.where(P > 0, torch.log(P), 0.0), dim=1)
        return H, P

    beta = torch.ones(n, device=D2.device)
    lo = torch.zeros(n, device=D2.device)
    hi = torch.full((n,), torch.inf, device=D2.device)
    for _ in range(iters):
        H, _ = entropy_probs(beta)
        too_high = H > target          # entropy too high -> raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    return entropy_probs(beta)[1]


def tsne_from(X: torch.Tensor, Y0: torch.Tensor, *,
              perplexity: float = 30.0, iters: int = 500,
              lr: float = 10.0) -> torch.Tensor:
    """t-SNE of X (n, d) from the initial embedding Y0 (n, dim).

    Exaggeration 12 and momentum 0.5 for the first 100 iterations, then 1
    and 0.8; Y is re-centred after every step.  Returns (n, dim).
    """
    n = X.shape[0]
    D = kops.pairwise_dist(X)
    P = _cond_probs(D * D, perplexity)
    P = torch.clamp((P + P.T) / (2.0 * n), min=1e-12)
    eye = torch.eye(n, dtype=torch.bool, device=X.device)

    def grad(Y, exaggeration):
        d2 = torch.sum((Y[:, None] - Y[None]) ** 2, dim=-1)
        num = (1.0 / (1.0 + d2)).masked_fill(eye, 0.0)
        Q = torch.clamp(num / torch.sum(num), min=1e-12)
        PQ = (exaggeration * P - Q) * num
        return 4.0 * (torch.sum(PQ, dim=1, keepdim=True) * Y - PQ @ Y)

    Y, V = Y0, torch.zeros_like(Y0)
    with full_f32():
        for t in range(iters):
            exag, mom = (12.0, 0.5) if t < 100 else (1.0, 0.8)
            V = mom * V - lr * grad(Y, exag)
            Y = Y + V
            Y = Y - torch.mean(Y, dim=0)
    return Y


def tsne(X: torch.Tensor, generator: torch.Generator, *,
         perplexity: float = 30.0, iters: int = 500, dim: int = 2,
         lr: float = 10.0) -> torch.Tensor:
    """X (n, d) -> (n, dim) embedding: ``tsne_from`` an initial embedding
    of N(0, 1e-4) draws from ``generator`` (on X's device)."""
    Y0 = 1e-2 * torch.randn((X.shape[0], dim), generator=generator,
                            device=X.device)
    return tsne_from(X, Y0, perplexity=perplexity, iters=iters, lr=lr)

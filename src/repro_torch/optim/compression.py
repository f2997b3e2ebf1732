"""Error-feedback top-k gradient compression for the DP axis.

As ``repro/optim/compression.py``.  EF-top-k keeps only the largest
``frac`` fraction of each gradient tensor of rank >= 2 (by magnitude),
carries the residual forward (error feedback guarantees convergence), and
lets a data-parallel all-reduce move ~frac of the bytes.  Here the
compression is the sparsification and the error feedback; the bytes saving
is realized where the gradients are reduced over ranks.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import _unzip, tree_map


class EFState(NamedTuple):
    residual: Any  # same-structure tree of carried-forward error (f32)


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """1 where |x| reaches the k-th largest magnitude (k = frac of the
    entries, at least 1), else 0, in x's dtype."""
    k = max(1, int(frac * x.numel()))
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def compress(grads, ef: EFState, frac: float):
    """Returns (sparse grads to all-reduce, new EF state)."""
    def one(g, r):
        acc = g.float() + r
        if acc.ndim < 2:          # don't sparsify norms/biases
            return acc, torch.zeros_like(acc)
        sent = acc * _topk_mask(acc, frac)
        return sent, acc - sent

    sent, new_r = _unzip(tree_map(one, grads, ef.residual), 2)
    return sent, EFState(residual=new_r)

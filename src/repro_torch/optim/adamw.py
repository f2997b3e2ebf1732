"""Optimizers: AdamW and Adafactor(-style factored second moment).

As ``repro/optim/adamw.py``, on the params dict of tensors (no
``torch.optim``: its AdamW decays every tensor, and the reference decays
only tensors of rank >= 2, after the Adam ratio).  Adafactor is the memory
play for the 671B config: first moment in bf16, second moment factored
into row/col statistics — O(d_in + d_out) instead of O(d_in * d_out) per
matrix — with update clipping and a momentum-free mode at ``b1 == 0``.

The step, the schedule and the bias corrections are 0-d f32 tensors on
the params' device, computed as the reference computes them in f32
(``b1 ** step``, ``step ** -0.8``, the cosine), never Python floats,
which would round them from f64.  Reductions over the tree (the global
norm) walk the leaves in sorted key order, JAX's tree order.

``apply_opt(..., donate=True)`` writes the new params and moments into the
old tensors (the reference's ``donate_argnums``): the same arithmetic, in
the same order, on the tensors themselves instead of copies, so the two
routes agree bit for bit and a full-width step holds one optimizer state.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any        # first moment (adamw: f32; adafactor: bf16 or None)
    v: Any        # second moment (adamw: f32 tree; adafactor: factored)


# ------------------------------------------------------------- trees ----


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict trees of one structure: a new tree in
    the first tree's key order.  The other trees may hold anything at the
    first tree's leaves (a tuple, None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict tree in JAX's order: keys sorted at every
    level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _unzip(tree, n: int):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda r, i=i: r[i], tree) for i in range(n))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------- schedule ----


def cosine_lr(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay, a 0-d f32 tensor on step's
    device."""
    warm = torch.clamp_max(step / max(tc.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    return tc.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def clip_by_global_norm(grads, max_norm: float, *, inplace: bool = False):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling as a 0-d f32 tensor).  The leaves' squared sums add in
    JAX's tree order.  ``inplace`` scales the given tensors."""
    gn = 0
    for g in tree_leaves(grads):
        gn = gn + torch.sum(torch.square(g.float()))
    gn = torch.sqrt(gn)
    scale = torch.clamp_max(max_norm / (gn + 1e-9), 1.0)

    def one(g):
        if inplace and g.dtype == torch.float32:
            return g.mul_(scale)
        out = (g.float() * scale).to(g.dtype)
        return g.copy_(out) if inplace else out
    return tree_map(one, grads), gn


# ------------------------------------------------------------- AdamW ----


def adamw_init(params) -> OptState:
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _adamw_leaf(p, g, m, v, *, tc, lr, bc1, bc2, donate):
    """One leaf: (new p, new m, new v).  ``donate`` writes into p, m, v;
    otherwise into copies.  Each line keeps the reference's rounding
    order: ``b1 * m + (1 - b1) * g``, ``b2 * v + (1 - b2) * g * g``,
    ``mhat / (sqrt(vhat) + 1e-8)`` (+ ``wd * p``), ``p - lr * delta``."""
    b1, b2 = tc.b1, tc.b2
    gf = g.float()
    if not donate:
        m, v = m.clone(), v.clone()
    m.mul_(b1).add_(gf * (1 - b1))
    v.mul_(b2).add_(gf * (1 - b2) * gf)
    delta = m / bc1
    delta.div_((v / bc2).sqrt_().add_(1e-8))
    if p.ndim >= 2:  # decoupled weight decay on matrices only
        delta.add_(p.float() * tc.weight_decay)
    delta.mul_(lr)
    if donate and p.dtype == torch.float32:
        return p.sub_(delta), m, v
    new = (p.float() - delta).to(p.dtype)
    return (p.copy_(new) if donate else new), m, v


def adamw_update(tc: TrainConfig, params, grads, st: OptState, *,
                 donate: bool = False):
    step = st.step + 1
    lr = cosine_lr(tc, step)
    f = step.float()
    bc1 = 1 - torch.pow(_f32(tc.b1, f.device), f)
    bc2 = 1 - torch.pow(_f32(tc.b2, f.device), f)
    res = tree_map(lambda p, g, m, v: _adamw_leaf(
        p, g, m, v, tc=tc, lr=lr, bc1=bc1, bc2=bc2, donate=donate),
        params, grads, st.m, st.v)
    new_p, new_m, new_v = _unzip(res, 3)
    return new_p, OptState(step=step, m=new_m, v=new_v)


# --------------------------------------------------------- Adafactor ----


def adafactor_init(params, *, momentum: bool = True) -> OptState:
    device = tree_leaves(params)[0].device

    def m_init(p):
        return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)

    def v_init(p):
        z = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return (torch.zeros(p.shape[:-1], **z),        # row stats
                    torch.zeros((*p.shape[:-2], p.shape[-1]), **z))
        return torch.zeros(p.shape, **z)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(m_init, params) if momentum else None,
                    v=tree_map(v_init, params))


def _laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` with ``like``'s placements, so that a second moment keeps the
    state's layout under a mesh: a factored moment whose mean ran over a
    sharded dim is a pending sum, completed here (an all-reduce of the
    small statistic), and the outer product of the two statistics then
    comes out placed as the weight.  ``x`` itself off a mesh."""
    placements = getattr(like, "placements", None)
    if placements is None or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(like.device_mesh, placements)


def _adafactor_leaf(p, g, m, v, *, tc, lr, b2):
    gf = g.float()
    g2 = gf * gf + 1e-30
    if p.ndim >= 2:
        vr, vc = v
        vr2 = _laid_out_as(b2 * vr + (1 - b2) * torch.mean(g2, dim=-1), vr)
        vc2 = _laid_out_as(b2 * vc + (1 - b2) * torch.mean(g2, dim=-2), vc)
        denom = (vr2[..., None] * vc2[..., None, :]
                 / (torch.mean(vr2, dim=-1, keepdim=True)[..., None]
                    + 1e-30))
        u = gf * torch.rsqrt(denom + 1e-30)
        v2 = (vr2, vc2)
    else:
        v2 = _laid_out_as(b2 * v + (1 - b2) * g2, v)
        u = gf * torch.rsqrt(v2 + 1e-30)
    # update clipping (RMS <= 1)
    rms = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    if m is None:                 # momentum-free (Shazeer-Stern) mode
        m2, delta = None, u
    else:
        delta = tc.b1 * m.float() + (1 - tc.b1) * u
        m2 = delta.to(torch.bfloat16)
    if p.ndim >= 2:
        delta = delta + tc.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m2, v2


def adafactor_update(tc: TrainConfig, params, grads, st: OptState, *,
                     donate: bool = False):
    step = st.step + 1
    lr = cosine_lr(tc, step)
    b2 = 1.0 - step.float() ** -0.8  # Shazeer-Stern decay
    m = st.m if st.m is not None else tree_map(lambda p: None, params)
    res = tree_map(lambda p, g, m_, v: _adafactor_leaf(
        p, g, m_, v, tc=tc, lr=lr, b2=b2), params, grads, m, st.v)
    new_p, new_m, new_v = _unzip(res, 3)
    if st.m is None:
        new_m = None
    if donate:   # the factored v is small: write p and m back in place
        tree_map(lambda old, new: old.copy_(new), params, new_p)
        if new_m is not None:
            tree_map(lambda old, new: old.copy_(new), st.m, new_m)
        new_p, new_m = params, st.m
    return new_p, OptState(step=step, m=new_m, v=new_v)


def init_opt(tc: TrainConfig, params) -> OptState:
    if tc.optimizer == "adamw":
        return adamw_init(params)
    return adafactor_init(params, momentum=tc.b1 > 0.0)


def apply_opt(tc: TrainConfig, params, grads, st: OptState, *,
              donate: bool = False):
    """(new params, new OptState).  ``donate`` updates params and the
    moments in place (the old state is consumed)."""
    if tc.optimizer == "adamw":
        return adamw_update(tc, params, grads, st, donate=donate)
    return adafactor_update(tc, params, grads, st, donate=donate)

"""train_step / serve_step builders, as ``repro/train/steps.py``.

``loss_fn`` is the reference's loss (chunked or full-logits CE, the z-loss,
the model's aux losses).  ``build_train_step`` returns
``train_step(state, batch) -> (state, metrics)``: the loss and its
gradient by autograd, the global-norm clip, the optional error-feedback
compression, and the optimizer.  The whole value-and-grad runs under
``kernels.ref.full_f32``: the forward, the backward and the recomputation
of rematerialized layers, so no product of the step uses TF32, whatever
the process set (the flag is process-wide, so the autograd engine's device
thread sees it too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels.ref import full_f32
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.optim import adamw as O
from repro_torch.optim import compression as C

Z_LOSS = 1e-4


class TrainState(NamedTuple):
    params: dict
    opt: O.OptState
    ef: C.EFState | None


def loss_fn(params, cfg: ModelConfig, batch):
    """(total loss, {"loss", "ce", "aux"}) as 0-d f32 tensors on the params'
    device; labels < 0 are masked out."""
    with full_f32():
        labels = M._tokens(params, batch["labels"])
        if cfg.ce_chunk > 0 or sharding.dp_axes() is not None:
            # chunked CE: the (B, S, V) f32 logits never materialize;
            # under a mesh the labels' logits come from the hidden states
            h, aux = M.forward(params, cfg, batch, return_hidden=True)
            ce_sum, z_sum, cnt = M.ce_from_hidden(params, cfg, h, labels,
                                                  chunk=cfg.ce_chunk)
        else:
            logits, aux = M.forward(params, cfg, batch)    # logits f32
            ce_sum, z_sum, cnt = M.ce_sums(logits, labels)
        denom = torch.clamp_min(cnt, 1.0)
        ce = ce_sum / denom
        zloss = Z_LOSS * z_sum / denom
        total = ce + zloss + aux
    return total, {"loss": total, "ce": ce, "aux": aux}


def _paths(tree, prefix=""):
    """("a/b" path, leaf) pairs of a dict tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _with_leaves(tree, leaves: dict, prefix=""):
    """A copy of the dict tree with the leaves at the paths of ``leaves``
    replaced (the others shared)."""
    return {k: _with_leaves(v, leaves, f"{prefix}{k}/")
            if isinstance(v, dict) else leaves.get(f"{prefix}{k}", v)
            for k, v in tree.items()}


def value_and_grad(params, cfg: ModelConfig, batch, targets=None):
    """(metrics, grads): ``loss_fn``'s metrics and its gradient, under
    ``full_f32``, for every leaf (grads a tree of params' structure) or
    for the "/"-joined leaf paths in ``targets`` only (grads a tree of
    those leaves).  Autograd runs on detached views of the params, which
    are not modified; a leaf the loss does not reach gets zeros."""
    leaves = dict(_paths(params))
    paths = list(leaves) if targets is None else list(targets)
    views = {p: leaves[p].detach().requires_grad_() for p in paths}
    with full_f32(), torch.enable_grad():
        total, metrics = loss_fn(_with_leaves(params, views), cfg, batch)
        grads = torch.autograd.grad(total, list(views.values()),
                                    allow_unused=True)
    by_path = {p: torch.zeros_like(v) if g is None else g
               for (p, v), g in zip(views.items(), grads)}
    if targets is None:
        tree = _with_leaves(params, by_path)
    else:
        tree = {}
        for p, g in by_path.items():
            *parents, name = p.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = g
    return {k: v.detach() for k, v in metrics.items()}, tree


def init_state(cfg: ModelConfig, tc: TrainConfig, generator: torch.Generator,
               param_dtype=torch.float32, *, device="cuda") -> TrainState:
    """Random params on ``device`` (``generator`` lives there), the
    optimizer's zero state and, with ``tc.compress_grads``, a zero
    error-feedback residual."""
    params = M.init_params(cfg, generator, dtype=param_dtype, device=device)
    return TrainState(params=params, opt=O.init_opt(tc, params),
                      ef=C.ef_init(params) if tc.compress_grads else None)


def build_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                     donate: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` are 0-d tensors.

    The input state is left as it was, unless ``donate``: then the params
    and the optimizer's moments are updated in place (the reference's
    ``donate_argnums=(0,)``), so a step holds one optimizer state, and the
    returned state shares the input's tensors.  Both give the same bits.
    """

    def train_step(state: TrainState, batch):
        metrics, grads = value_and_grad(state.params, cfg, batch)
        with torch.no_grad(), full_f32():
            # the gradients are the step's own: scale them in place
            grads, gnorm = O.clip_by_global_norm(grads, tc.grad_clip,
                                                 inplace=True)
            ef = state.ef
            if ef is not None:
                grads, ef = C.compress(grads, ef, tc.topk_frac)
            params, opt = O.apply_opt(tc, state.params, grads, state.opt,
                                      donate=donate)
        del grads
        return (TrainState(params=params, opt=opt, ef=ef),
                dict(metrics, grad_norm=gnorm))

    return train_step


def greedy_next(logits):
    """The greedy pick of a decode step: (B, S, V) logits -> (B, 1) int32,
    the argmax of the last position.  Under a mesh the vocabulary is
    gathered first (batch over the DP axes): ``DTensor``'s argmax over a
    split vocabulary fails at B 1 (long_500k)."""
    last = sharding.hint(logits[:, -1, :], "dp", None)
    return torch.argmax(last, dim=-1).to(torch.int32)[:, None]


def build_serve_step(cfg: ModelConfig, *, greedy: bool = True):
    """Returns ``serve_step(params, cache, tokens, pos) -> (next_tokens,
    cache)``: one new token per request stream against the decode cache
    (written in place), the next token the logits' argmax, (B, 1) int32.
    ``pos`` is a host integer."""

    def serve_step(params, cache, tokens, pos):
        with torch.inference_mode():
            logits, cache = M.decode_step(params, cfg, tokens, cache, pos)
            nxt = greedy_next(logits)
        return nxt, cache

    return serve_step

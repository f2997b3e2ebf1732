"""Dense FFN and Mixture-of-Experts FFN with capacity-based dispatch
(GShard-style), as ``repro/models/moe.py``.

Position computation is the reference's slot-major cumsum: entries are
ordered (slot, token) so slot 0 of every token beats slot 1 for buffer
space, and tokens that overflow an expert's capacity are *dropped*
(contribute zero; the residual stream carries them).

Two choices keep the result the same bits run after run on the card,
where the reference's scatter-adds would become atomics:

* the top-k (of experts, and of groups) is a stable descending sort, so
  equal probabilities go to the lower index, as ``jax.lax.top_k`` does;
* the dispatch writes each kept entry into its own (expert, slot) by index
  (no two kept entries share one; dropped ones go to a spare row that is
  cut off), and the combine adds a token's K weighted contributions in
  slot order, ``y += g[k]`` for k = 0..K-1, the order in which the
  reference's ``.at[tok].add`` visits them.

The expert products are batched over the expert dim (``torch.einsum``,
plain torch, as the reference computes them outside any Pallas kernel).
The reference's five sharding hints stand at its points
(``models/sharding.py::hint``: the FFN's wide dim over ``model``, the
tokens over the DP axes, the expert buffers over ``model``, or over
``model`` x ``data`` under ``set_ep2d``), the identity without a mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.common import activation, seq_whole, seq_whole_grad


def dense_ffn(p, h, cfg, prefix: str = "w"):
    """Gated (or plain) FFN: h (B,S,D) -> (B,S,D)."""
    act = activation(cfg.act)
    h = seq_whole(h)
    up = sharding.hint(h @ p[f"{prefix}_up"], "dp", None, "model")
    if cfg.gated:
        gate = sharding.hint(act(h @ p[f"{prefix}_gate"]), "dp", None,
                             "model")
        inner = gate * up
    else:
        inner = act(up)
    return seq_whole_grad(inner @ p[f"{prefix}_down"])


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, h, cfg, *, return_logits: bool = False):
    """MoE FFN: returns (out (B,S,D), aux_loss 0-d f32).

    p: router (D,E); e_gate/e_up (E,D,F); e_down (E,F,D); optional
    shared-expert weights s_gate/s_up/s_down.

    With ``return_logits=True`` also returns the (T, E) float32 router
    logits, for the monitor's router probes.
    """
    B, S, D = h.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    x = sharding.hint(seq_whole(h).reshape(T, D), "dp", None)

    logits = (x @ p["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if cfg.route_groups > 1:
        # group-limited routing (DeepSeek-V3): keep only the top-g expert
        # groups per token
        G = cfg.route_groups
        gsz = E // G
        gscore = _top_k(probs.reshape(T, G, gsz), min(2, gsz))[0].sum(-1)
        _, gidx = _top_k(gscore, cfg.route_top_groups)
        gmask = torch.zeros((T, G), dtype=torch.bool, device=h.device)
        gmask.scatter_(1, gidx, True)
        probs = torch.where(gmask.repeat_interleave(gsz, dim=1), probs, 0.0)
    w, ids = _top_k(probs, K)                             # (T, K)
    w = (w / (w.sum(-1, keepdim=True) + 1e-9)).to(h.dtype)
    # the dispatch numbers every token's entries in one order, so the
    # routing decisions are whole on every rank (the batch axis gathered)
    ids, w = sharding.hint(ids, None, None), sharding.hint(w, None, None)

    cap = max(int(K * T * cfg.capacity_factor / E), 1)

    # slot-major flattening: (K*T,) with slot 0 entries first
    ids_f = ids.T.reshape(-1)                             # (KT,)
    oh = F.one_hot(ids_f, E)                              # (KT, E)
    pos_in_e = (oh.cumsum(0) * oh).sum(1) - 1
    keep = pos_in_e < cap

    # dispatch: each kept entry into its own (expert, slot) of the
    # (E, cap, D) buffer; dropped entries into the spare row E*cap.  Entry
    # i is token i mod T: the tokens repeated K times, whose backward sums
    # the K copies in a fixed order (a gather's backward adds by atomics)
    slot = torch.where(keep, ids_f * cap + pos_in_e, E * cap)
    flat = h.new_zeros((E * cap + 1, D))
    flat = torch.index_put(flat, (slot,), x.repeat(K, 1))
    buf = flat[:E * cap].view(E, cap, D)
    e_axes = ("model", "data") if sharding.ep2d() else "model"
    b_axis = None if sharding.ep2d() else "dp"
    buf = sharding.hint(buf, e_axes, b_axis, None)

    # expert compute (batched over the expert dim)
    act = activation(cfg.act)
    up = torch.einsum("ecd,edf->ecf", buf, p["e_up"])
    if cfg.gated:
        inner = act(torch.einsum("ecd,edf->ecf", buf, p["e_gate"])) * up
    else:
        inner = act(up)
    out_buf = sharding.hint(torch.einsum("ecf,efd->ecd", inner, p["e_down"]),
                            e_axes, b_axis, None)

    # combine: gather each entry's expert output, weight, add to its token
    # in slot order
    pos_c = pos_in_e.clamp(0, cap - 1)
    # any entry may read any (expert, slot): the buffer whole on each rank
    gathered = sharding.hint(out_buf, None, None, None)[ids_f, pos_c]
    gathered = torch.where(keep[:, None], gathered, 0.0) \
        * w.T.reshape(-1)[:, None]
    # (its gradient whole too: (K, T) cannot flatten a split T back)
    gathered = sharding.grad_hint(gathered.view(K, T, D), None, None, None)
    y = torch.zeros((T, D), dtype=h.dtype, device=h.device)
    for k in range(K):
        y = y + gathered[k]

    # load-balance auxiliary loss (Switch/GShard form)
    frac_tokens = F.one_hot(ids[:, 0], E).float().mean(0)
    frac_prob = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_prob) * cfg.router_aux_coef

    if cfg.n_shared_experts > 0:
        y = y + dense_ffn(p, h, cfg, prefix="s").reshape(T, D)
    y = seq_whole_grad(y.reshape(B, S, D))
    if return_logits:
        return y, aux, logits
    return y, aux

"""Dense FFN and Mixture-of-Experts FFN with capacity-based dispatch
(GShard-style), as ``repro/models/moe.py``.

Position computation is the reference's slot-major numbering: entries are
ordered (slot, token) so slot 0 of every token beats slot 1 for buffer
space, and tokens that overflow an expert's capacity are *dropped*
(contribute zero; the residual stream carries them).  An entry's position
is its rank among its expert's entries in that order, taken from a stable
sort (``_positions``): the integers of the reference's one-hot cumsum in
O(K*T) memory.  The aux loss's token fractions are counts
(``_token_fractions``), with the one-hot mean's bits.

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
(``models/sharding.py::hint``), the identity without a mesh.

Under a mesh the layout is the reference's expert parallelism, and no
rank holds the whole (E, cap, D) buffer or K*T entries of width D:

* ``x`` (T, D): the tokens over the DP axes, whole over "model".  The
  routing decisions ``ids`` and ``w`` (T, K) are whole on every rank, since
  the numbering needs every token's entries in one order.
* The buffer and the expert outputs (E, cap, D): E over "model" (over
  "model" x "data" under ``set_ep2d``), cap over the DP axes (whole under
  ``set_ep2d``), as the reference's hints place them.
* Dispatch.  Each rank writes its own tokens' entries into the part of the
  buffer its tokens may reach: its own shard along the mesh dims that do
  not split the tokens ("model"), every shard along those that do, at most
  1/|model| of the buffer.  A reduce-scatter over each token dim that
  splits the buffer leaves the rank its own shard.  An all-reduce over a
  token dim that does not split it completes the shard: the "pod" of
  ``set_ep2d`` on two pods, where the reference keeps the buffer whole.
* Combine.  All-gathers over the same dims give each rank that part of the
  expert outputs.  It gathers its own tokens' entries, with zeros for those
  whose (expert, slot) lies in another rank's part.  An all-reduce over the
  other dims ("model") completes each entry.  The sum is exact: one addend
  of each entry is nonzero, so the values are the one-rank step's, up to
  the sign of a zero.  Then the K contributions are added in slot order.
  ``y`` comes back with the tokens' layout.
* The gradients take the same paths: each collective's backward is its
  adjoint (``sharding.scatter_sum``, ``gather_rows``, ``sum_over``).

Dispatch and combine run on each rank's local tensors: ``DTensor``
unshards an advanced-index gather or an ``index_put`` whose operand is
sharded (torch 2.11).  Without a mesh the same code runs with one part,
the whole buffer, and no collective.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

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


def _positions(ids_f: torch.Tensor, E: int) -> torch.Tensor:
    """Each entry's rank among the entries of its expert, in entry order:
    ``(F.one_hot(ids_f, E).cumsum(0) * one_hot).sum(1) - 1`` without the
    (len, E) one-hot.  A stable sort groups each expert's entries in entry
    order; an entry's rank is its place in the sort less its expert's
    first place."""
    sorted_ids, order = torch.sort(ids_f, stable=True)
    first = torch.searchsorted(sorted_ids, torch.arange(
        E, dtype=ids_f.dtype, device=ids_f.device))
    ranks = torch.arange(ids_f.shape[0], device=ids_f.device) \
        - first[sorted_ids]
    return torch.empty_like(ranks).scatter_(0, order, ranks)


def _token_fractions(top1: torch.Tensor, E: int) -> torch.Tensor:
    """``F.one_hot(top1, E).float().mean(0)`` without the (T, E) one-hot,
    the same bits: each expert's count (exact in f32 below 2**24 tokens),
    then the mean's own last step, a division by T on the CPU and a
    product with f32(E) / f32(T * E) (the CUDA reduction's factor) on the
    card."""
    T = top1.shape[0]
    counts = torch.zeros(E, dtype=torch.float32, device=top1.device)
    counts.index_add_(0, top1, torch.ones(T, dtype=torch.float32,
                                          device=top1.device))
    if counts.device.type == "cpu":
        return counts.div_(T)
    return counts.mul_(float(np.float32(E) / np.float32(T * E)))


class _Part(NamedTuple):
    """A rank's part of the dispatch: its tokens ``[t0, t0 + tl)`` and the
    (g * e_b, cap_b) rows of the buffer its tokens may reach, ``g`` blocks
    of its (e_b, cap_b) shard's shape.  ``splits`` has, for each mesh dim
    that splits the buffer (mesh order), ``(mesh dim, buffer dim (0: E, 1:
    cap), size, stride, this rank's coordinate, whether it splits the
    tokens)``; ``sums`` the mesh dims that split the tokens and not the
    buffer.  Without a mesh: one part, everything."""
    t0: int
    tl: int
    e_b: int
    cap_b: int
    splits: tuple = ()
    sums: tuple = ()
    mesh: Any = None

    @property
    def g(self) -> int:
        return math.prod(n for _, _, n, _, _, tok in self.splits if tok)

    def rows(self, e: torch.Tensor, c: torch.Tensor):
        """(row, slot, covered) of entries at expert ``e``, position ``c``
        (< cap) in the part: ``covered`` is False where (e, c) lies in
        another rank's part, None when no entry can."""
        if not self.splits:
            return e, c, None
        be, bc = e // self.e_b, c // self.cap_b
        g, covered = 0, None
        for _, dim, n, stride, coord, tok in self.splits:
            k = ((be if dim == 0 else bc) // stride) % n
            if tok:
                g = g * n + k
            else:
                covered = (k == coord) if covered is None \
                    else covered & (k == coord)
        return g * self.e_b + e % self.e_b, c % self.cap_b, covered


def _part(x, shape: tuple, entries: tuple):
    """(part, buffer placements) of this rank, for ``x`` placed over the
    tokens and a buffer of ``shape`` hinted as ``entries``."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    sizes = list(sharding.mesh_sizes(mesh).values())
    coord = mesh.get_coordinate()
    pl = sharding.placements(sharding.resolve(shape, entries, mesh), mesh)
    tok = [isinstance(p, Shard) for p in x.placements]
    t_idx, n_tok = 0, 1
    for n, c, t in zip(sizes, coord, tok):
        if t:
            t_idx, n_tok = t_idx * n + c, n_tok * n
    splits, per = [], [1, 1]
    for i in reversed(range(len(pl))):
        if isinstance(pl[i], Shard):
            d = pl[i].dim
            splits.insert(0, (i, d, sizes[i], per[d], coord[i], tok[i]))
            per[d] *= sizes[i]
    sums = tuple(i for i, p in enumerate(pl)
                 if tok[i] and not isinstance(p, Shard))
    tl = x.shape[0] // n_tok
    return _Part(t_idx * tl, tl, shape[0] // per[0], shape[1] // per[1],
                 tuple(splits), sums, mesh), pl


def _dispatch(x, row, slot, mine, part: _Part, K: int):
    """The rank's shard (e_b, cap_b, D) of the buffer: its tokens' entries
    (``mine``: kept, and in its part at ``row``, ``slot``) written into its
    part, then summed into the shards over the token dims."""
    D = x.shape[1]
    n = part.g * part.e_b * part.cap_b
    # each kept entry into its own (expert, slot); dropped entries, and
    # those of another rank's part, into the spare row n.  Entry i is token
    # i mod tl: the tokens repeated K times, whose backward sums the K
    # copies in a fixed order (a gather's backward adds by atomics)
    flat = x.new_zeros((n + 1, D))
    flat = torch.index_put(flat, (torch.where(mine, row * part.cap_b + slot,
                                              n),), x.repeat(K, 1))
    buf = flat[:n].view(part.g * part.e_b, part.cap_b, D)
    for i, _, _, _, _, tok in part.splits:
        if tok:
            buf = sharding.scatter_sum(buf, part.mesh, i)
    for i in part.sums:
        buf = sharding.sum_over(buf, part.mesh, i)
    return buf


def _combine(out, row, slot, mine, w_o, part: _Part, K: int):
    """The rank's tokens' outputs (tl, D): each entry's expert output from
    the part, complete once summed over the other dims, weighted by
    ``w_o``, and added to its token in slot order."""
    for i, _, _, _, _, tok in reversed(part.splits):
        if tok:
            out = sharding.gather_rows(out, part.mesh, i)
    gathered = torch.where(mine[:, None], out[row, slot], 0.0)
    for i, _, _, _, _, tok in part.splits:
        if not tok:
            gathered = sharding.sum_over(gathered, part.mesh, i)
    gathered = (gathered * w_o[:, None]).view(K, part.tl, out.shape[-1])
    y = torch.zeros((part.tl, out.shape[-1]), dtype=out.dtype,
                    device=out.device)
    for k in range(K):
        y = y + gathered[k]
    return y


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
        gmask = (gidx[:, :, None] == torch.arange(
            G, device=h.device)).any(1)                  # (T, G)
        probs = torch.where(gmask.repeat_interleave(gsz, dim=1), probs, 0.0)
    w, ids = _top_k(probs, K)                             # (T, K)
    w = (w / (w.sum(-1, keepdim=True) + 1e-9)).to(h.dtype)
    # the dispatch numbers every token's entries in one order, so the
    # routing decisions are whole on every rank (the batch axis gathered)
    ids, w = sharding.hint(ids, None, None), sharding.hint(w, None, None)

    cap = max(int(K * T * cfg.capacity_factor / E), 1)
    e_axes = ("model", "data") if sharding.ep2d() else "model"
    b_axis = None if sharding.ep2d() else "dp"
    if sharding.dp_axes() is None:
        part, x_l, ids_l, w_l = _Part(0, T, E, cap), x, ids, w
    else:
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        n_tok = math.prod(n for n, pl in zip(x.device_mesh.shape,
                                             x.placements) if pl.is_shard())
        if B % n_tok:       # a rank's tokens must be whole batch rows
            x = sharding.hint(x, None, None)
        part, buf_pl = _part(x, (E, cap, D), (e_axes, b_axis, None))
        tok = [pl.is_shard() for pl in x.placements]
        x_l = x.to_local(grad_placements=[
            Shard(0) if t else Partial() if b.is_shard() else Replicate()
            for t, b in zip(tok, buf_pl)])
        ids_l = ids.to_local()
        w_l = w.to_local(grad_placements=[Partial() if t else Replicate()
                                          for t in tok])

    # slot-major numbering of the (K*T,) entries; each rank's own tokens'
    # entries are a (K, tl) block of it
    ids_f = ids_l.T.reshape(-1)                           # (KT,)
    pos_in_e = _positions(ids_f, E)

    def own(t):
        return t.view(K, T)[:, part.t0:part.t0 + part.tl].reshape(-1)

    ids_o, pos_o = own(ids_f), own(pos_in_e)
    keep = pos_o < cap
    pos_c = pos_o.clamp(0, cap - 1)
    row, slot, covered = part.rows(ids_o, pos_c)
    mine = keep if covered is None else keep & covered

    buf = _dispatch(x_l, row, slot, mine, part, K)
    if part.mesh is not None:
        buf = DTensor.from_local(buf, part.mesh, buf_pl, run_check=False)
    buf = sharding.hint(buf, e_axes, b_axis, None)

    # expert compute (batched over the expert dim).  Where the tokens split
    # over a mesh dim that the buffer is whole on (``sums``: the "pod" of
    # ``set_ep2d``), the experts' gradient is a sum over it, done per layer
    # so that it reaches the optimizer laid out as the experts
    ew = {k: p[k] for k in ("e_gate", "e_up", "e_down") if k in p}
    if part.sums:
        ew = {k: sharding.grad_like(w) for k, w in ew.items()}
    act = activation(cfg.act)
    up = torch.einsum("ecd,edf->ecf", buf, ew["e_up"])
    if cfg.gated:
        inner = act(torch.einsum("ecd,edf->ecf", buf, ew["e_gate"])) * up
    else:
        inner = act(up)
    out_buf = sharding.hint(torch.einsum("ecf,efd->ecd", inner, ew["e_down"]),
                            e_axes, b_axis, None)

    if part.mesh is not None:
        out_buf = out_buf.to_local(grad_placements=[
            Partial() if i in part.sums else pl
            for i, pl in enumerate(buf_pl)])
    y = _combine(out_buf, row, slot, mine, own(w_l.T.reshape(-1)), part,
                 K).view(part.tl // S, S, D)
    frac_tokens = _token_fractions(ids_l[:, 0], E)
    if part.mesh is not None:
        y = DTensor.from_local(y, part.mesh, x.placements, run_check=False)
        frac_tokens = DTensor.from_local(
            frac_tokens, part.mesh, [Replicate()] * part.mesh.ndim,
            run_check=False)

    # load-balance auxiliary loss (Switch/GShard form)
    frac_prob = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_prob) * cfg.router_aux_coef

    if cfg.n_shared_experts > 0:
        y = y + dense_ffn(p, h, cfg, prefix="s")
    y = seq_whole_grad(y)
    if return_logits:
        return y, aux, logits
    return y, aux

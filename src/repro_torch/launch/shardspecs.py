"""Input, state and cache shardings for the launchers (train and serve),
as ``repro/launch/shardspecs.py``.

Each function returns ``models.sharding.NamedSharding``s: the spec tuple
(the reference's ``PartitionSpec``, for parity) and its placements on the
mesh (for the dry run).  The trees walked are the port's: the batch dict,
``TrainState`` / ``OptState`` NamedTuples of dict trees, and the decode
cache's NamedTuples.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import (mesh_sizes, named, param_shardings,
                                         spec)


def _dp(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def _dpsize(mesh) -> int:
    sizes, n = mesh_sizes(mesh), 1
    for a in _dp(mesh):
        n *= sizes[a]
    return n


def batch_shardings(cfg: ModelConfig, mesh, specs: dict) -> dict:
    """Shardings for the input batch dict (tokens/labels/patches/frames):
    the batch dim over the DP axes when it divides."""
    dp, dpsize = _dp(mesh), _dpsize(mesh)
    out = {}
    for name, t in specs.items():
        lead = dp if t.shape[0] % dpsize == 0 else None
        out[name] = named(spec(lead, *([None] * (t.ndim - 1))), mesh)
    return out


def _recheck(sp, shape, mesh):
    """Divisibility-validate a raw spec list against a concrete shape."""
    sizes = mesh_sizes(mesh)
    ok = []
    for dim, s in enumerate(list(sp)[:len(shape)]):
        names = (s,) if isinstance(s, str) else tuple(s or ())
        total = 1
        for nm in names:
            total *= sizes.get(nm, 1)
        ok.append(s if total and shape[dim] % total == 0 else None)
    ok += [None] * (len(shape) - len(ok))
    return named(spec(*ok), mesh)


def _like(p_sh, tree, mesh):
    """Shardings of a tree of the params' structure (a moment, a residual):
    each leaf's param spec rechecked against its shape; a factored
    ``(vr, vc)`` drops the reduced dim from the spec."""
    if isinstance(tree, dict):
        return {k: _like(p_sh[k], v, mesh) for k, v in tree.items()}
    sp = list(p_sh.spec)
    if isinstance(tree, tuple):                    # factored (vr, vc)
        return (_recheck(sp[:-1], tree[0].shape, mesh),
                _recheck(sp[:-2] + [sp[-1]], tree[1].shape, mesh))
    return _recheck(sp, tree.shape, mesh)


def state_shardings(state, mesh):
    """TrainState shardings.

    params / first moment reuse the param rules directly.  Adafactor's
    factored second moment derives from the param spec by *dropping the
    reduced dim*: vr (row stats, mean over last dim) keeps spec[:-1];
    vc (col stats, mean over dim -2) keeps spec[:-2] + spec[-1].  This is
    what keeps the 61x256-expert stat tensors sharded over the expert dim
    instead of replicating hundreds of GB.
    """
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.steps import TrainState
    p_sh = param_shardings(state.params, mesh)
    opt = state.opt
    return TrainState(
        params=p_sh,
        opt=OptState(step=named((), mesh),
                     m=None if opt.m is None else _like(p_sh, opt.m, mesh),
                     v=_like(p_sh, opt.v, mesh)),
        ef=None if state.ef is None else type(state.ef)(
            residual=_like(p_sh, state.ef.residual, mesh)))


def cache_shardings(cfg: ModelConfig, mesh, cache, batch: int,
                    max_len: int):
    """Decode-cache shardings, a tree of the cache's structure.

    Rules (by dim size, per leaf): the batch dim shards over the DP axes
    when divisible; KV/state head dims shard over `model` when divisible;
    if batch cannot shard (long_500k: B=1), the max_len dim shards over
    `data` instead (context-sharded cache), and over `model` when no head
    count divides (whisper's 20 heads on a 16-way axis).
    """
    dp, sizes = _dp(mesh), mesh_sizes(mesh)
    m = sizes.get("model", 1)
    d = sizes.get("data", 1)
    batch_ok = batch % _dpsize(mesh) == 0
    head_sizes = {cfg.eff_kv_heads, cfg.eff_heads}
    if cfg.family == "hybrid":
        head_sizes.add(cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim)
    if cfg.family == "ssm":
        head_sizes.add(cfg.d_model // cfg.rwkv_head_dim)
    heads_shardable = any(h % m == 0 for h in head_sizes)

    def one(leaf):
        sp = []
        used_batch = used_seq = used_head = False
        for dim in leaf.shape:
            if dim == batch and not used_batch:
                sp.append(dp if batch_ok else None)
                used_batch = True
            elif dim == max_len and not used_seq and not batch_ok:
                sp.append("data" if dim % d == 0 else None)
                used_seq = True
            elif (dim == max_len and not used_seq and not heads_shardable
                  and dim % m == 0):
                sp.append("model")
                used_seq = True
            elif dim in head_sizes and not used_head and dim % m == 0:
                sp.append("model")
                used_head = True
            else:
                sp.append(None)
        return named(spec(*sp), mesh)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple):   # NamedTuple states and the enc_kv pair
            return type(t)(*(walk(v) for v in t)) if hasattr(t, "_fields") \
                else tuple(walk(v) for v in t)
        return one(t)

    return walk(cache)

"""Logical-axis sharding rules for the model zoo, as
``repro/models/sharding.py``.

Mesh axes: ``("data", "model")`` for one pod, ``("pod", "data", "model")``
for two.  Logical placement:

  * batch             -> ("pod", "data")        (DP)
  * TP / EP           -> "model"                (heads, d_ff, experts, vocab)
  * FSDP weight shard -> "data"                 (the d_model-ish dim)
  * stacked layer dim -> replicated

Divisibility fallback: a dim not divisible by its mesh axes' size is left
unsharded (whisper's 20 heads or 51,866 vocab on a 16-wide model axis).

A rule gives a *spec*: a tuple with one entry a tensor dim, each ``None``,
a mesh axis name or a tuple of names, the reference's ``PartitionSpec``
as a tuple (a one-name tuple is written as the name, as JAX writes it).
``placements`` turns a spec into ``torch.distributed.tensor`` placements,
one a mesh dim: ``Shard(dim)`` on every mesh dim that the entry of tensor
dim ``dim`` names, ``Replicate()`` on the others.  An entry that names two
axes shards its dim over both in the mesh's own order, as one flattened
mesh dim would (no ``_StridedShard``): for ``("pod", "data")`` that is the
reference's order; for ``("model", "data")`` (2-D expert parallelism) a
rank holds the data-major block where JAX gives it the model-major one, a
block of the same shape, so bytes and collectives a rank are the same.

The mesh is anything with axis names (``axis_names`` or a
``DeviceMesh``'s ``mesh_dim_names``) and sizes (``devices.shape`` or
``shape``).  ``hint`` places activations; it returns its argument itself
when no mesh is set, so single-card and CPU runs never see sharding.
``grad_hint`` places a gradient the same way, and ``on_shards`` runs a
region whose ops are all local (a loop that carries a state) on each
rank's shards, so no step of it reshards; without a mesh both are the
identity and a plain call.  ``scatter_sum``, ``gather_rows`` and
``sum_over`` are collectives over one mesh dim for such a region's local
tensors (the moe dispatch and combine), each with its adjoint as its
backward.

``set_census`` makes the dry run's op census reachable from model code
while it traces a step (``census()``; None otherwise): ``common.scan`` asks
it to count a recurrence's step once for every position.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

# module-level mesh context for activation hints; set by launchers
_ACTIVE: dict[str, Any] = {"mesh": None, "dp": None, "ep2d": False,
                           "census": None}


class NamedSharding(NamedTuple):
    """A leaf's spec (the reference's ``PartitionSpec`` as a tuple) and
    its placements on the mesh."""
    spec: tuple
    placements: tuple


def set_ep2d(on: bool) -> None:
    """2-D expert parallelism: distribute experts over model x data instead
    of EP(model) + FSDP(data).  Kills the per-step all-gather of the full
    expert stack; expert weights live whole on one device row, tokens move
    via all-to-all."""
    _ACTIVE["ep2d"] = on


def ep2d() -> bool:
    return _ACTIVE["ep2d"]


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_sizes(mesh) -> dict[str, int]:
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else mesh.shape
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


def set_mesh(mesh) -> None:
    """Register the active mesh for activation hints (None to disable)."""
    if mesh is None:
        _ACTIVE["mesh"] = None
        _ACTIVE["dp"] = None
        return
    _ACTIVE["mesh"] = mesh
    _ACTIVE["dp"] = (("pod", "data") if "pod" in axis_names(mesh)
                     else ("data",))


def dp_axes() -> tuple[str, ...] | None:
    return _ACTIVE["dp"]


def set_census(census) -> None:
    """The op census of the step being traced (``launch.dryrun.Census``),
    or None when the trace ends."""
    _ACTIVE["census"] = census


def census():
    return _ACTIVE["census"]


def spec(*entries) -> tuple:
    """A spec tuple written as JAX writes a ``PartitionSpec``: a one-name
    tuple entry becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(sp: tuple, mesh) -> tuple:
    """The spec as one placement a mesh dim (see the module docstring); a
    mesh dim of size 1 replicates, which is the same layout."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in mesh_sizes(mesh).items():
        dims = [d for d, e in enumerate(sp) if name in _names(e)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def named(sp: tuple, mesh) -> NamedSharding:
    return NamedSharding(sp, placements(sp, mesh))


def resolve(shape, entries, mesh) -> tuple:
    """``hint``'s spec for a tensor of ``shape``: "dp" expands to the
    batch axes; a dim not divisible by its axes' size falls back to
    None."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, s in enumerate(entries):
        if s == "dp":
            s = _ACTIVE["dp"]
        names = _names(s)
        if not names:
            out.append(None)
            continue
        total = 1
        for nm in names:
            total *= sizes.get(nm, 1)
        out.append(None if shape[dim] % total else
                   (names if len(names) > 1 else names[0]))
    return spec(*out)


def hint(x: torch.Tensor, *entries) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: without a mesh, ``x``
    itself.  With one, ``x`` as a ``DTensor`` redistributed to the
    resolved spec (a plain tensor is taken as replicated first); autograd
    redistributes its gradient back."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    pl = placements(resolve(x.shape, entries, mesh), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


class _GradHint(torch.autograd.Function):
    """The identity, whose backward ``hint``s the gradient."""

    @staticmethod
    def forward(ctx, x, entries):
        ctx.entries = entries
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return hint(g, *ctx.entries), None


def grad_hint(x: torch.Tensor, *entries) -> torch.Tensor:
    """``x`` as it is, its gradient placed by ``hint(g, *entries)``: for a
    product whose output is summed into a stream laid out otherwise (the
    forward keeps the pending sum, reduced as the stream lies; the
    backward hands the product a gradient laid out as it needs).  ``x``
    itself without a mesh, or off autograd."""
    if (_ACTIVE["mesh"] is None or not torch.is_grad_enabled()
            or not x.requires_grad):
        return x
    return _GradHint.apply(x, entries)


class _GradLike(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the input
    lies."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient laid out as ``x`` lies: for a weight
    replicated over a mesh dim that splits the tokens it is used on, whose
    gradient is a pending sum over that dim (an all-reduce per use, as
    data parallelism reduces a gradient).  ``x`` itself without a mesh, off
    a mesh or off autograd."""
    from torch.distributed.tensor import DTensor
    if (_ACTIVE["mesh"] is None or not isinstance(x, DTensor)
            or not torch.is_grad_enabled() or not x.requires_grad):
        return x
    return _GradLike.apply(x)


def placed_alike(ts, dims: tuple[int, ...]) -> bool:
    """Whether the ``DTensor``s ``ts`` have one set of placements, each
    shard on one of ``dims``: what ``on_shards`` needs of a region that
    pairs their elements index by index.  False without a mesh."""
    if _ACTIVE["mesh"] is None:
        return False
    from torch.distributed.tensor import DTensor, Shard
    if not all(isinstance(t, DTensor) for t in ts):
        return False
    pl = tuple(ts[0].placements)
    return (all(tuple(t.placements) == pl for t in ts)
            and all(p.is_replicate() or isinstance(p, Shard) and p.dim in dims
                    for p in pl))


def on_shards(fn, args: tuple, like: tuple) -> tuple:
    """``fn(*args)`` run on each rank's local shards, for a region whose
    every op is local as ``args`` lie (a recurrence over heads placed by
    ``hint``, the reference's scan carry); result ``i`` comes back as a
    ``DTensor`` placed as ``like[i]``, which must be how ``fn`` leaves it.
    Under ``DTensor`` each op of a loop would be propagated one at a time
    and could reshard a step; on the shards a loop costs one dispatch a
    tensor.  An arg's local gradient is placed as the arg, except on a
    mesh dim where the arg is whole and another arg is split: there each
    rank's gradient is the part its own shards give, ``Partial`` (rwkv6's
    ``u`` beside a split batch, mamba2's ``Bm`` beside split heads).
    Without a mesh, ``fn(*args)`` itself."""
    if _ACTIVE["mesh"] is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial
    dts = [a for a in args if isinstance(a, DTensor)]
    split = [any(a.placements[i].is_shard() for a in dts)
             for i in range(dts[0].device_mesh.ndim)] if dts else []
    outs = fn(*(a.to_local(grad_placements=[
        Partial() if p.is_replicate() and s else p
        for p, s in zip(a.placements, split)])
        if isinstance(a, DTensor) else a for a in args))
    return tuple(DTensor.from_local(o, l.device_mesh, l.placements,
                                    run_check=False)
                 for o, l in zip(outs, like, strict=True))


def _c10d(mesh, dim) -> tuple[int, str]:
    return mesh.size(dim), mesh.get_group(dim).group_name


def _reduce_scatter(t, mesh, dim):
    n, name = _c10d(mesh, dim)
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.reduce_scatter_tensor(t.contiguous(), "sum",
                                                     n, name))


def _all_gather(t, mesh, dim):
    n, name = _c10d(mesh, dim)
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_gather_into_tensor(t.contiguous(), n,
                                                      name))


def _all_reduce(t, mesh, dim):
    _, name = _c10d(mesh, dim)
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(t.contiguous(), "sum", name))


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _reduce_scatter(t, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(t, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.dim), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        return _all_reduce(t, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# Collectives on the local tensors of a region run on each rank's shards,
# over one mesh dim, with their adjoints as backward: the census counts
# them as it counts ``DTensor``'s own.

def scatter_sum(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The sum over mesh dim ``dim`` of every rank's ``t``, each rank
    keeping its chunk of dim 0 (a reduce-scatter; backward an
    all-gather)."""
    return _ScatterSum.apply(t, mesh, dim)


def gather_rows(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``t`` over mesh dim ``dim``, stacked along dim 0 in the
    ranks' order (an all-gather; backward a reduce-scatter)."""
    return _GatherRows.apply(t, mesh, dim)


def sum_over(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The sum over mesh dim ``dim`` of every rank's ``t`` (an all-reduce).
    The result is the same on those ranks, and so is its gradient, which
    the backward passes on as it is."""
    return _SumOver.apply(t, mesh, dim)


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight where it is used, its FSDP shard gathered: a dim sharded
    over "data" alone becomes replicated over "data" (an all-gather, and
    in the backward a reduce-scatter of its gradient), what the
    reference's compiler does with an FSDP-sharded weight; the other
    placements, and a dim sharded over "data" jointly with "model" (2-D
    experts), are kept.  ``w`` itself without a mesh or off a mesh."""
    if _ACTIVE["mesh"] is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(w, DTensor):
        return w
    names = axis_names(w.device_mesh)
    dims = [p.dim if isinstance(p, Shard) else None for p in w.placements]
    pl = tuple(Replicate() if n == "data" and d is not None
               and dims.count(d) == 1 else p
               for n, d, p in zip(names, dims, w.placements))
    if pl == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def _settled(x):
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


class _SettledGrad(torch.autograd.Function):
    """The identity, whose backward settles the gradient (a partial
    gradient cannot be redistributed back into a masked partial value)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _settled(g)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending reductions done and its shards kept: a
    ``DTensor``'s ``Partial`` placements redistributed to ``Replicate``
    (an all-reduce in the census), and its gradient so too, for an op
    that cannot carry a partial value through (the vocab-parallel
    lookup's and gather's masks, a sharded max or sum).  ``x`` itself
    without a mesh."""
    if _ACTIVE["mesh"] is None:
        return x
    out = _settled(x)
    if out is x or not torch.is_grad_enabled() or not out.requires_grad:
        return out
    return _SettledGrad.apply(out)


def _divis(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def spec_for(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """The spec of one parameter leaf, keyed on its path name.

    Weight naming convention (see models/model.py init):
      wq wk wv wo w_gate w_up w_down  — attention / FFN projections
      e_gate e_up e_down router       — MoE experts (leading E dim)
      embed lm_head pos_*             — vocab-space tables
      in_proj out_proj (ssm/rwkv)     — wide fused projections
      everything else (norms, biases, decay vectors) — replicated
    """
    sizes = mesh_sizes(mesh)
    m = sizes.get("model", 1)
    d = sizes.get("data", 1)
    leaf = path.split("/")[-1]
    nd = len(shape)

    def ax(i: int, name: str, size: int):
        return name if _divis(shape[i], size) else None

    if leaf in ("embed", "lm_head", "mtp_head"):
        # (V, D) or (D, V): shard vocab over model, other dim over data
        if leaf == "embed":
            return spec(ax(0, "model", m), ax(1, "data", d))
        return spec(ax(0, "data", d), ax(1, "model", m))
    if leaf.startswith("pos_"):
        return spec(*([None] * nd))
    if leaf in ("e_gate", "e_up", "e_down"):
        if _ACTIVE["ep2d"] and shape[1] % (m * d) == 0:
            # 2-D EP: experts spread over model x data, no FSDP gather
            return spec(None, ("model", "data"), None, None)
        # (L, E, Din, Dout): experts over model (EP), inner over data
        if leaf == "e_down":
            return spec(None, ax(1, "model", m), None, ax(3, "data", d))
        return spec(None, ax(1, "model", m), ax(2, "data", d), None)
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj",
                "wq_a", "wq_b", "wkv_a", "wkv_b", "w_recv", "w_key",
                "w_val", "w_gateproj"):
        # (..., D_in, D_wide): FSDP on D_in, TP on the wide dim
        return spec(*([None] * (nd - 2)),
                    ax(nd - 2, "data", d), ax(nd - 1, "model", m))
    if leaf in ("wo", "w_down", "out_proj", "w_out"):
        # (..., D_wide, D_out): TP on the wide dim, FSDP on D_out
        return spec(*([None] * (nd - 2)),
                    ax(nd - 2, "model", m), ax(nd - 1, "data", d))
    if leaf == "router":
        return spec(*([None] * (nd - 2)), ax(nd - 2, "data", d), None)
    # depthwise conv kernels (mamba), norms, scalar-ish leaves: replicated
    return spec(*([None] * nd))


def param_shardings(params: dict, mesh, prefix: str = "") -> dict:
    """A dict tree of ``NamedSharding`` matching ``params`` (tensors of
    any device, "meta" included), keyed by the "/"-joined paths that
    ``models.model.params_from_numpy`` reads."""
    return {k: param_shardings(v, mesh, f"{prefix}{k}/")
            if isinstance(v, dict)
            else named(spec_for(f"{prefix}{k}", tuple(v.shape), mesh), mesh)
            for k, v in params.items()}

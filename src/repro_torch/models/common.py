"""Shared building blocks: norms, RoPE, activations, initializers, and
``scan``, the port's ``lax.scan``.

As ``repro/models/common.py``, on tensors.  ``dense_init`` draws from an
explicit ``torch.Generator``: the reference's ``keygen`` key splitter has
no counterpart, since one generator is passed through and drawn from in
order.
"""
from __future__ import annotations

import contextlib
import gc
import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale``, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B,S,...) with ``n`` zero rows before its first, the values of
    ``F.pad(x, (0, 0, n, 0))``, by a ``cat``, which ``DTensor`` shards as
    ``x`` lies under every torch version (a pad it may not)."""
    zeros = torch.zeros_like(x[:, :1]).expand(x.shape[0], n, *x.shape[2:])
    return torch.cat([zeros, x], dim=1)


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """A sublayer's (B,S,D) input with its sequence whole on each rank
    (batch over the DP axes): under ``seq_shard`` the residual stream's
    sequence is split over "model", and a product's (B*S, D) view, a shift
    or a pad cannot carry that split, so the sublayer gathers it once
    here.  ``x`` itself without a mesh."""
    return sharding.hint(x, "dp", None, None)


def seq_whole_grad(x: torch.Tensor) -> torch.Tensor:
    """A sublayer's (B,S,D) output, whose gradient comes back with its
    sequence whole on each rank: under ``seq_shard`` the residual stream
    it joins splits the sequence over "model", and the product behind it
    cannot take that split in its backward.  The forward is ``x`` as it
    is; ``x`` itself without a mesh."""
    return sharding.grad_hint(x, "dp", None, None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _relu2(x: torch.Tensor) -> torch.Tensor:  # nemotron squared ReLU
    return torch.square(F.relu(x))


def activation(name: str):
    if name in ("swiglu",):
        return F.silu
    if name in ("geglu", "gelu"):
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(f"unknown activation {name}")


def rope_freqs(positions: torch.Tensor, dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for `positions` (any shape) over `dim` rope dims.

    The frequencies theta^(-i/half) are computed in f64 and rounded to f32
    (correctly rounded, as XLA's f32 power gives them; torch's f32 power
    may be an ulp off, which at positions in the thousands moves an angle
    by 1e-4)."""
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(theta, exps.double()).float()
    ang = positions.float()[..., None] * freq  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) with cos/sin (..., S, hd/2) — rotate-half
    convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over the head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def sinusoidal_pos(seq: int, dim: int, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """Classic transformer sinusoidal position table (whisper encoder)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10_000.0)
                    * torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device) / dim)
    tab = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab.to(dtype)


#: erf(∓2/√2): the uniform range whose inverse-erf image is N(0, 1)
#: truncated to [-2, 2], as ``jax.random.truncated_normal(key, -2, 2)``
#: draws it.
_ERF_LO, _ERF_HI = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))


def dense_init(generator: torch.Generator, shape: tuple[int, ...],
               scale: float | None = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init (0.02-style for embeds, 1/sqrt(fan_in)
    else): a standard normal truncated at ±2, drawn in f32 by the inverse
    error function (the reference's method; the draws differ), times
    ``scale``, cast to ``dtype``.  ``generator`` lives on ``device``; on
    "meta" nothing is drawn (a shape stand-in)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(_ERF_LO, _ERF_HI, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale)
    return t.to(dtype)


# ---------------------------------------------------------------- scan ----

#: the fewest positions ``scan`` traces once on "meta" tensors (fewer run
#: as the loop): the forward runs the last of ``_VJP_RUNS``, the numbers of
#: positions whose VJPs the backward runs
_ONCE_MIN = 8
_VJP_RUNS = (3, 4, 5, 6)


def scan(step, carry, xs: tuple, consts: tuple = ()):
    """``jax.lax.scan`` over sequence-first ``xs``: at each position ``t``,
    ``carry, y = step(carry, tuple(x[t] for x in xs), *consts)``; returns
    the last carry and the ys stacked on a new leading dim.  ``carry`` and
    each ``y`` are tensors; ``consts`` are the tensors every step reads
    (passed, not closed over, so that their gradient reaches them).

    It is that Python loop, op for op, except on plain "meta" tensors
    while the dry run's census counts a step (``sharding.census()``):
    there the step is traced once, as XLA traces a scan's body
    (``_ScanOnce``), and the census counts every position the loop would
    run from a few that run, so the trace takes the same time at any S.
    Fewer than ``_ONCE_MIN`` positions run as the loop there too."""
    tensors = (carry, *xs, *consts)
    if (sharding.census() is not None and xs[0].shape[0] >= _ONCE_MIN
            and all(type(t) is torch.Tensor and t.is_meta for t in tensors)):
        return _ScanOnce.apply(step, len(xs), torch.is_grad_enabled(),
                               *tensors)
    return _loop(step, carry, xs, consts, xs[0].shape[0])


def _loop(step, carry, xs, consts, n: int):
    """``scan``'s loop over positions 0..n-1."""
    ys = []
    for t in range(n):
        carry, y = step(carry, tuple(x[t] for x in xs), *consts)
        ys.append(y)
    return carry, torch.stack(ys)


# The census (``sharding.census()``, the dry run's ``Census``) as ``scan``
# uses it: ``counts()`` -> (FLOPs, bytes accessed, live bytes, collective
# bytes) so far; ``add(flops, accessed)``; ``quiet()``, a context whose
# ops are neither counted nor ever live; ``hold(t)``, ``t``'s storage live
# until it is freed.

def _minus(a: tuple, b: tuple) -> tuple:
    return tuple(x - y for x, y in zip(a, b))


def _add(census, *terms) -> None:
    """Count sum(k * counts) over the (k, counts) ``terms``: FLOPs and
    bytes accessed."""
    census.add(sum(k * c[0] for k, c in terms),
               sum(k * c[1] for k, c in terms))


def _alike(a: tuple, b: tuple, what: str, live: bool = True) -> None:
    """Raise unless two positions' counts agree (FLOPs, bytes accessed,
    live bytes added if ``live``) and neither ran a collective."""
    keep = (0, 1, 2) if live else (0, 1)
    if [a[i] for i in keep] != [b[i] for i in keep] or a[3] or b[3]:
        raise RuntimeError(
            f"scan: {what} counts {a} at one position and {b} at the next "
            "(FLOPs, bytes accessed, live bytes, collective bytes; for a "
            "VJP, second differences); a step traced once must count "
            "alike at every position and run no collective")


def _detached(ts, need, census) -> list:
    """``ts`` cut from their graph; those that ``need`` a gradient as
    views of new leaves of their shapes, whose storage is never live (the
    inputs' own is held by the node, as the loop's saved slices hold it)
    and which autograd saves and unpacks as it does the loop's inputs,
    which are no leaves."""
    with census.quiet(), torch.enable_grad():
        return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device="meta").requires_grad_()
                .view_as(t) if n else t.detach()
                for t, n in zip(ts, need)]


def _storage_bytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


@contextlib.contextmanager
def _no_gc():
    """Python's cycle collector held off, so that no storage another part
    of the step left behind is freed while a position's live bytes are
    counted."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class _ScanOnce(torch.autograd.Function):
    """``scan`` on "meta" tensors under the census: the loop's outputs,
    counts and live storage, from a few positions run as the loop runs
    them.

    Forward: positions 0..5 run under the census as the loop runs them,
    autograd recording as the loop's would (under the saved-tensor hooks
    in force: checkpointing drops their residuals, or recomputes them, as
    it does the loop's); positions 1..5 must count alike (FLOPs, bytes
    accessed, live bytes added; no collective), or it raises.  The census
    counts the other S - 6 positions and the stack of S ys (the stacks of
    1, 2 and 3 ys give its cost, which must grow alike).  Storage of what
    the loop holds for the other positions is made and counted live: their
    ys, then the stacked ys, and their residuals, saved for the backward
    so that checkpointing drops them as it drops the loop's.
    Backward: the six positions' graph is let go, and the VJP of the loop
    over 3, 4, 5 and 6 positions runs on the saved inputs, its residuals
    live and freed as its backward goes, as the loop's first steps free
    theirs.  Its counts grow with the positions as a polynomial of degree
    2 (each step's VJP alike; the stack's VJP selects each of n gradients
    from an (n, ...) one), so the second differences of the four runs
    must agree, and the census counts that polynomial at S.  The
    gradients are the last run's: the inputs' shapes."""

    @staticmethod
    def forward(ctx, step, nx, grad_on, *ins):
        with _no_gc():
            return _ScanOnce._forward(ctx, step, nx, grad_on, ins)

    @staticmethod
    def backward(ctx, g_carry, g_ys):
        with _no_gc():
            return _ScanOnce._backward(ctx, g_carry, g_ys)

    @staticmethod
    def _forward(ctx, step, nx, grad_on, ins):
        ctx.set_materialize_grads(False)
        census = sharding.census()
        S, run = ins[1].shape[0], _VJP_RUNS[-1]
        leaves = _detached(ins, [t.requires_grad for t in ins], census)
        c, xs, consts = leaves[0], leaves[1:1 + nx], leaves[1 + nx:]
        ys, per = [], []
        with torch.set_grad_enabled(grad_on):
            for t in range(run):
                before = census.counts()
                c, y = step(c, tuple(x[t] for x in xs), *consts)
                ys.append(y)
                per.append(_minus(census.counts(), before))
        for p in per[2:]:
            _alike(per[1], p, "a step")
        stacks = []
        with torch.no_grad():
            for n in (1, 2, 3):
                before = census.counts()
                torch.stack(ys[:n])
                stacks.append(_minus(census.counts(), before))
        grow = _minus(stacks[1], stacks[0])
        _alike(grow, _minus(stacks[2], stacks[1]), "the stack", live=False)
        # the ys' graph stays with the node until its backward: what its
        # saved tensors hold (or, under checkpointing, where they are
        # recomputed) is what the loop's graph holds for these positions,
        # as the loss reaches it (the carry's last node is reached only
        # from the last carry)
        ctx.graph = [y.grad_fn for y in ys]
        ctx.step, ctx.nx = step, nx
        # whether saved tensors go through hooks (checkpointing's), whose
        # unpacking the loop's backward then counts
        ctx.hooked = torch._C._autograd._top_saved_tensors_default_hooks(
            False) is not None
        # the other S - 6 positions, and the stack of S ys in place of the
        # three stacks above
        _add(census, (S - run, per[1]), (1, stacks[0]), (S - 1, grow),
             *((-1, st) for st in stacks))
        # what the loop holds for the other positions before its stack
        # (their residuals and ys), then the stacked ys, then the S ys
        # freed
        y_bytes = _storage_bytes(y)
        with census.quiet():
            res, listed = (torch.empty(n, dtype=torch.uint8, device="meta")
                           for n in ((S - run) * (per[1][2] - y_bytes),
                                     (S - run) * y_bytes))
            ys_out = torch.empty((S, *y.shape), dtype=y.dtype, device="meta")
        for t in (res, listed, ys_out):
            census.hold(t)
        # the last carry, in storage that also holds what the loop's graph
        # keeps for it alone (its last node's saved tensors): both go when
        # the carry does
        shape, dtype, c_bytes = c.shape, c.dtype, _storage_bytes(c)
        live = census.counts()[2]
        del c
        extra = live - census.counts()[2] - c_bytes
        with census.quiet():
            buf = torch.empty(c_bytes + extra, dtype=torch.uint8,
                              device="meta")
            c = buf[:c_bytes].view(dtype).view(shape)
        census.hold(buf)
        # the inputs and the residuals saved as empty views, which keep
        # their storage as the loop's saved slices do, while saving and
        # unpacking them count nothing (and checkpointing, which checks
        # that a saved tensor's shape is the same when it is recomputed,
        # sees the residuals' view alike when they are not kept)
        ctx.ins = [(t.shape, t.stride(), t.dtype) for t in ins]
        with census.quiet():
            empty = [t[:0] for t in (*ins, res)]
        del listed, ys, y
        ctx.save_for_backward(*empty)
        return c, ys_out

    @staticmethod
    def _backward(ctx, g_carry, g_ys):
        census = sharding.census()
        # held to the end of the backward (under checkpointing nothing
        # else holds a tensor once it is unpacked)
        kept = ctx.saved_tensors
        ctx.graph = None    # the runs below hold these positions' residuals
        need = ctx.needs_input_grad[3:]
        with census.quiet():
            ins = [torch.empty_strided(*m[:2], dtype=m[2], device="meta")
                   for m in ctx.ins]
        costs = []
        for m in _VJP_RUNS:
            grads = None        # one run's gradients live at a time
            grads, cost = _vjp(ctx, ins, need, m, g_carry, g_ys, census)
            costs.append(cost)
        d = [_minus(b, a) for a, b in zip(costs, costs[1:])]
        dd = _minus(d[1], d[0])
        _alike(dd, _minus(d[2], d[1]), "a step's VJP", live=False)
        n = ins[1].shape[0] - _VJP_RUNS[0]
        _add(census, (1, costs[0]), (n, d[0]), (n * (n - 1) // 2, dd))
        return (None, None, None, *grads)


def _vjp(ctx, ins, need, m, g_carry, g_ys, census):
    """The loop's VJP over positions 0..m-1 of the saved inputs ``ins``:
    (the gradients of the inputs that ``need`` them, the backward's counts
    (FLOPs, bytes accessed, live bytes, collective bytes)), counted by
    the census only in that return.  Its forward's saved tensors go
    through hooks if the loop's did (``ctx.hooked``), so that unpacking
    them counts as it does there; its outputs are not live (the loop's
    are the node's), nor is the last carry kept when it has no
    gradient."""
    nx, step = ctx.nx, ctx.step
    hooks = (torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                      lambda t: t)
             if ctx.hooked else contextlib.nullcontext())
    leaves = _detached(ins, need, census)
    c, xs, consts = leaves[0], leaves[1:1 + nx], leaves[1 + nx:]
    with census.quiet():
        g_ys = None if g_ys is None else g_ys[:m]
    start = census.counts()
    ys = []
    with torch.enable_grad(), hooks:
        for t in range(m):
            c, y = step(c, tuple(x[t] for x in xs), *consts)
            ys.append(y)
        with census.quiet():
            ys = torch.stack(ys)
    del y
    outs = [(o, g) for o, g in ((ys, g_ys), (c, g_carry)) if g is not None]
    del c, ys
    want = [t for t in leaves if t.requires_grad]
    mid = census.counts()
    got = iter(torch.autograd.grad([o for o, _ in outs],
                                   want, [g for _, g in outs],
                                   allow_unused=True)
               if outs and want else [None] * len(want))
    end = census.counts()
    _add(census, (-1, _minus(end, start)))
    return [next(got) if n else None for n in need], _minus(end, mid)

"""CUDA kernel: one fused matrix-free Prim step a launch.

The port of ``repro/kernels/prim_stream.py::prim_stream_step_pallas``, the
flashvat rung's stepwise engine (``turbo=False``), of its batched form
``prim_stream_step_pallas_batch``, and of ``prim_frontier_step_pallas``,
the step of the sharded engine (``core.distributed.
vat_matrix_free_sharded``).  The kernel is ``csrc/prim_stream.cu``: every
lane folds the pivot's row into the frontier (in place), and a packed-key
reduction across CTAs, finished by the last CTA of the launch, gives the
masked first-index (min, argmin).

The engines build one step object a traversal, ``StreamRecord`` or
``FrontierStep``: it checks the tensors, makes the feature-major copy of X
the kernel reads and the zeroed scratch (one ticket a lane, one value a
CTA) once, and each step is then one C call and one launch on the stream
that was current when it was built.  The stepwise step records the
traversal itself (``order[t]``, ``edges[t]`` and ``selected[next]``), so a
loop of steps is nothing but these calls and never waits on the host.

``prim_stream_step_cuda``, ``prim_stream_step_batch_cuda`` and
``prim_frontier_step_cuda`` are the single-call forms, with the pivot given
as a device index (or, for the frontier, a table of slots): each makes the
copy and the scratch for its one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import (_KINDS, check_cuda,
                                              check_lanes)
from repro_torch.kernels.ref import check_metric, slot_width
from repro_torch.numerics.condition import check_form


def _check_points(X: torch.Tensor, batched: bool) -> tuple:
    """(b, n, d) of a non-empty float32 X, (n, d) or (b, n, d)."""
    want = 3 if batched else 2
    if X.dtype != torch.float32 or X.dim() != want or 0 in X.shape:
        shape = "(b, n, d)" if batched else "(n, d)"
        raise ValueError(f"want a non-empty {shape} float32 X, got "
                         f"{X.dtype} {tuple(X.shape)}")
    if batched:
        check_lanes(X.shape[0])
        return tuple(X.shape)
    return (1, *X.shape)


def _check_state(aux, mind, selected, lead) -> None:
    lead = tuple(lead)
    if aux.dtype != torch.float32 or mind.dtype != torch.float32 \
            or selected.dtype != torch.bool \
            or not aux.shape == mind.shape == selected.shape == lead:
        raise ValueError(f"want {lead} float32 aux and mind and {lead} bool "
                         f"selected, got {aux.dtype} {tuple(aux.shape)}, "
                         f"{mind.dtype} {tuple(mind.shape)}, "
                         f"{selected.dtype} {tuple(selected.shape)}")


def _scratch(b: int, n: int, device) -> torch.Tensor:
    """A step's scratch for b lanes of n, tickets zeroed."""
    words = _build.library().repro_prim_stream_scratch_words(b, n)
    return torch.zeros(words, dtype=torch.int64, device=device)


def _feature_major(X: torch.Tensor) -> torch.Tensor:
    """X (.., n, d) as (.., d, n), contiguous: feature k of lane j at
    k n + j, the layout the kernel reads X in."""
    return X.transpose(-1, -2).contiguous()


class _RecordArgs(ctypes.Structure):
    """``ReproStreamRecordArgs`` of csrc/prim_stream.cu."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "XT", "X", "aux", "mind", "sel", "order", "edges", "scratch",
        "stream")]
        + [(name, ctypes.c_longlong) for name in ("b", "n", "d", "kind")])


class _FrontierArgs(ctypes.Structure):
    """``ReproFrontierStepArgs`` of csrc/prim_stream.cu."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "XT", "X", "aux", "table", "mind", "order", "edges", "scratch", "out",
        "stream")]
        + [(name, ctypes.c_longlong) for name in (
            "P", "W", "n", "d", "kind", "offset", "N")])


def _args(struct, tensors: dict, values: dict):
    """``struct`` filled with the tensors' addresses, the current stream and
    the values, and a pointer to it for the C call."""
    args = struct(**{k: t.data_ptr() for k, t in tensors.items()},
                  stream=torch.cuda.current_stream().cuda_stream, **values)
    return args, ctypes.c_void_p(ctypes.addressof(args))


class StreamRecord:
    """The stepwise engine's step for one traversal, on the card.

    Built once from the traversal's tensors; ``step(t)`` (1 <= t < n) then
    runs step t of every lane in one launch: the pivot is ``order[..,
    t - 1]``; ``mind`` folds its row in place; the first-index minimum over
    unselected lanes is written to ``order[.., t]`` and ``edges[.., t]``
    and marked in ``selected``.  ``ref.prim_stream_record_ref`` is the
    plain version.

    Args:
      X: (n, d) or (b, n, d) contiguous float32 CUDA tensor.
      aux: (n,) or (b, n) float32 — ``kernels.ops.metric_aux`` of X.
      mind, selected: float32 and bool, the shape of aux — the frontier
        and the visited mask, updated in place.
      order, edges: int64 and float32, the shape of aux — the traversal;
        entry t - 1 holds the pivot of step t.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" or "direct".
    """

    def __init__(self, X: torch.Tensor, aux: torch.Tensor,
                 mind: torch.Tensor, selected: torch.Tensor,
                 order: torch.Tensor, edges: torch.Tensor, *,
                 metric: str = "euclidean", form: str = "gram"):
        check_metric(metric)
        check_form(form)
        for t, name in ((X, "X"), (aux, "aux"), (mind, "mind"),
                        (selected, "selected"), (order, "order"),
                        (edges, "edges")):
            check_cuda(t, name)
        batched = X.dim() == 3
        b, n, d = _check_points(X, batched)
        lead = X.shape[:-1]
        _check_state(aux, mind, selected, lead)
        if order.dtype != torch.int64 or edges.dtype != torch.float32 \
                or not order.shape == edges.shape == lead:
            raise ValueError(f"want {tuple(lead)} int64 order and float32 "
                             f"edges, got {order.dtype} {tuple(order.shape)}"
                             f", {edges.dtype} {tuple(edges.shape)}")
        self.name = "prim_stream_step_batch" if batched else \
            "prim_stream_step"
        self._fn = _build.library().repro_prim_stream_record
        self._tensors = dict(XT=_feature_major(X), X=X, aux=aux, mind=mind,
                             sel=selected, order=order, edges=edges,
                             scratch=_scratch(b, n, X.device))
        self._struct, self._args = _args(
            _RecordArgs, self._tensors,
            dict(b=b, n=n, d=d, kind=_KINDS[(metric, form)]))

    def __call__(self, t: int) -> None:
        err = self._fn(self._args, t)
        if err:
            _build.check(err, self.name)
        _build.LAUNCHES[self.name] += 1


class FrontierStep:
    """The sharded engine's step for one traversal of this rank's shard,
    on the card.

    Built once; ``step(t)`` then runs step t in one launch: the pivot is
    the least-key slot of ``table``, recorded as ``order[t]`` and
    ``edges[t]``; its lane is closed to +inf if this shard holds it; its
    row is folded into ``mind`` in band, in place; and this rank's next
    slot goes to ``slot``.  ``ref.prim_frontier_round_ref`` is the plain
    version.

    Args:
      X: (n, d) contiguous float32 CUDA tensor — the shard, global ids
        ``offset`` .. ``offset + n - 1``.
      aux: (n,) float32 — ``kernels.ops.metric_aux`` of X.
      table: (P, ref.slot_width(d)) float32 — the gathered slots, refilled
        between steps.
      mind: (n,) float32 — the in-band frontier, updated in place.
      slot: (ref.slot_width(d),) float32 — receives this rank's next slot.
      order, edges: (N,) int64 and float32 — the traversal being recorded.
      offset: the global id of the shard's first lane.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" or "direct".
    """

    def __init__(self, X: torch.Tensor, aux: torch.Tensor,
                 table: torch.Tensor, mind: torch.Tensor, slot: torch.Tensor,
                 order: torch.Tensor, edges: torch.Tensor, *, offset: int = 0,
                 metric: str = "euclidean", form: str = "gram"):
        check_metric(metric)
        check_form(form)
        for tensor, name in ((X, "X"), (aux, "aux"), (table, "table"),
                             (mind, "mind"), (slot, "slot"),
                             (order, "order"), (edges, "edges")):
            check_cuda(tensor, name)
        _, n, d = _check_points(X, False)
        width = slot_width(d)
        if aux.dtype != torch.float32 or mind.dtype != torch.float32 \
                or not aux.shape == mind.shape == (n,):
            raise ValueError(f"want (n,) float32 aux and mind for n = {n}, "
                             f"got {aux.dtype} {tuple(aux.shape)}, "
                             f"{mind.dtype} {tuple(mind.shape)}")
        if table.dtype != torch.float32 or table.dim() != 2 \
                or table.shape[1] != width or table.shape[0] < 1 \
                or slot.dtype != torch.float32 or slot.shape != (width,):
            raise ValueError(f"want a (P, {width}) float32 table and a "
                             f"({width},) float32 slot for d = {d}, got "
                             f"{table.dtype} {tuple(table.shape)}, "
                             f"{slot.dtype} {tuple(slot.shape)}")
        if table.data_ptr() % 16:
            raise ValueError("table must start 16-byte aligned")
        if order.dtype != torch.int64 or edges.dtype != torch.float32 \
                or order.dim() != 1 or order.shape != edges.shape:
            raise ValueError(f"want (N,) int64 order and float32 edges, got "
                             f"{order.dtype} {tuple(order.shape)}, "
                             f"{edges.dtype} {tuple(edges.shape)}")
        if not 0 <= offset <= 2 ** 32 - 1 - n:
            raise ValueError(f"global ids offset .. offset + n - 1 must fit "
                             f"32 bits, got offset = {offset}, n = {n}")
        self._fn = _build.library().repro_prim_frontier_step
        self._tensors = dict(XT=_feature_major(X), X=X, aux=aux, table=table,
                             mind=mind, order=order, edges=edges,
                             scratch=_scratch(1, n, X.device), out=slot)
        self._struct, self._args = _args(
            _FrontierArgs, self._tensors,
            dict(P=table.shape[0], W=width, n=n, d=d,
                 kind=_KINDS[(metric, form)], offset=offset,
                 N=order.shape[0]))

    def __call__(self, t: int) -> None:
        err = self._fn(self._args, t)
        if err:
            _build.check(err, "prim_frontier_step")
        _build.LAUNCHES["prim_frontier_step"] += 1


def _step_pair(X: torch.Tensor, aux: torch.Tensor, q: torch.Tensor,
               mind: torch.Tensor, selected: torch.Tensor, *, metric: str,
               form: str, batched: bool) -> torch.Tensor:
    """One launch of the parity entry for b lanes; the (b, 2) int64 pair
    buffer."""
    check_metric(metric)
    check_form(form)
    for t, name in ((X, "X"), (aux, "aux"), (q, "q"), (mind, "mind"),
                    (selected, "selected")):
        check_cuda(t, name)
    b, n, d = _check_points(X, batched)
    _check_state(aux, mind, selected, X.shape[:-1])
    if q.dtype != torch.int64 or q.numel() != b \
            or (batched and q.shape != (b,)):
        want = "(b,)" if batched else "one"
        raise ValueError(f"q must be {want} int64, got {q.dtype} "
                         f"{tuple(q.shape)}")
    lib = _build.library()
    name = "prim_stream_step_batch" if batched else "prim_stream_step"
    out = torch.empty((b, 2), dtype=torch.int64, device=X.device)
    XT = _feature_major(X)
    scratch = _scratch(b, n, X.device)
    err = lib.repro_prim_stream_step(
        XT.data_ptr(), X.data_ptr(), aux.data_ptr(), q.data_ptr(),
        mind.data_ptr(), selected.data_ptr(), b, n, d,
        _KINDS[(metric, form)], scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def prim_stream_step_cuda(X: torch.Tensor, aux: torch.Tensor,
                          q: torch.Tensor, mind: torch.Tensor,
                          selected: torch.Tensor, *,
                          metric: str = "euclidean", form: str = "gram"):
    """One Prim step on the card: ``mind = min(mind, row q)``, in place,
    then the first-index (min, argmin) of mind over unselected lanes.

    Args:
      X: (n, d) contiguous float32 CUDA tensor.
      aux: (n,) float32 — ``kernels.ops.metric_aux`` of X.
      q: integer CUDA tensor of one element — the pivot.
      mind: (n,) float32 frontier, updated in place.
      selected: (n,) bool — True lanes are excluded from the argmin.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" or "direct".

    Returns:
      (mind, edge f32 0-d, next int64 0-d) — ``mind`` is the argument,
      updated; edge and next are views of one 2-element device buffer.
    """
    out = _step_pair(X, aux, q, mind, selected, metric=metric, form=form,
                     batched=False)[0]
    return mind, out[1:].view(torch.float32)[0], out[0]


def prim_stream_step_batch_cuda(X: torch.Tensor, aux: torch.Tensor,
                                q: torch.Tensor, mind: torch.Tensor,
                                selected: torch.Tensor, *,
                                metric: str = "euclidean",
                                form: str = "gram"):
    """One Prim step of each of b lanes on the card, in one launch:
    ``mind[z] = min(mind[z], row q[z] of X[z])``, in place, then each lane's
    first-index (min, argmin) over its unselected lanes.  Lane z runs the
    code of ``prim_stream_step_cuda`` on its own operands, so it gives that
    call's bits.

    Args:
      X: (b, n, d) contiguous float32 CUDA tensor, 1 <= b <= ``MAX_LANES``.
      aux: (b, n) float32 — ``kernels.ops.metric_aux`` of X.
      q: (b,) int64 CUDA tensor — each lane's pivot.
      mind: (b, n) float32 frontiers, updated in place.
      selected: (b, n) bool — True lanes are excluded from the argmin.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" or "direct".

    Returns:
      (mind, edge (b,) f32, next (b,) int64) — ``mind`` is the argument,
      updated; edge and next are views of one (b, 2) device buffer.
    """
    out = _step_pair(X, aux, q, mind, selected, metric=metric, form=form,
                     batched=True)
    return mind, out.view(torch.float32)[:, 2], out[:, 0]


def prim_frontier_step_cuda(X: torch.Tensor, aux: torch.Tensor,
                            table: torch.Tensor, mind: torch.Tensor,
                            slot: torch.Tensor, order: torch.Tensor,
                            edges: torch.Tensor, t: int, *, offset: int = 0,
                            metric: str = "euclidean", form: str = "gram"
                            ) -> torch.Tensor:
    """One step of the sharded engine on this rank's shard, on the card:
    ``FrontierStep`` built for this one step, which it runs.
    ``ref.prim_frontier_round_ref`` is the plain version.

    Args:
      X, aux, table, mind, slot, order, edges, offset, metric, form: as
        ``FrontierStep``'s.
      t: 0 <= t < N, the pivot's position in the order.

    Returns:
      ``mind``, updated.
    """
    step = FrontierStep(X, aux, table, mind, slot, order, edges,
                        offset=offset, metric=metric, form=form)
    if not 0 <= t < order.shape[0]:
        raise ValueError(f"want 0 <= t < N = {order.shape[0]}, got t = {t}")
    step(t)
    return mind

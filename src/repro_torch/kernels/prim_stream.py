"""CUDA kernel: one fused matrix-free Prim step, the pivot given by index.

The port of ``repro/kernels/prim_stream.py::prim_stream_step_pallas``, the
flashvat rung's stepwise engine (``turbo=False``).  The kernel is
``csrc/prim_stream.cu``: every lane folds the pivot's row into the frontier
(in place), and a packed-key reduction gives the masked first-index (min,
argmin).  The pivot comes in as a device index and the pair goes out into a
device buffer, so a loop of steps never waits on the host.

``prim_stream_step_batch_cuda`` is the port of
``prim_stream_step_pallas_batch``, the batched stepwise engine: one step of
b lanes in one launch pair, each lane's pivot by device index.

``prim_frontier_step_cuda`` is the port of ``prim_frontier_step_pallas``,
the step of the sharded engine (``core.distributed.
vat_matrix_free_sharded``): the pivot by value, as a slot of the last
step's all-gathered table, the frontier in band (+inf lanes never fold),
and this rank's next slot written for the next all-gather.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import (_KINDS, check_cuda,
                                              check_lanes)
from repro_torch.kernels.ref import check_metric, slot_width
from repro_torch.numerics.condition import check_form


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
    check_metric(metric)
    check_form(form)
    for t, name in ((X, "X"), (aux, "aux"), (q, "q"), (mind, "mind"),
                    (selected, "selected")):
        check_cuda(t, name)
    if X.dtype != torch.float32 or X.dim() != 2 or 0 in X.shape:
        raise ValueError(f"want a non-empty (n, d) float32 X, got {X.dtype} "
                         f"{tuple(X.shape)}")
    n, d = X.shape
    if aux.dtype != torch.float32 or mind.dtype != torch.float32 \
            or selected.dtype != torch.bool \
            or not aux.shape == mind.shape == selected.shape == (n,):
        raise ValueError("want (n,) float32 aux and mind and (n,) bool "
                         f"selected for n = {n}, got {aux.dtype} "
                         f"{tuple(aux.shape)}, {mind.dtype} "
                         f"{tuple(mind.shape)}, {selected.dtype} "
                         f"{tuple(selected.shape)}")
    if q.numel() != 1 or q.dtype != torch.int64:
        raise ValueError(f"q must be one int64, got {q.dtype} "
                         f"{tuple(q.shape)}")
    lib = _build.library()
    lanes = _build.PRIM_STREAM_LANES
    out = torch.empty(2, dtype=torch.int64, device=X.device)
    partial = (torch.empty(-(-n // lanes), dtype=torch.int64, device=X.device)
               if n > lanes else out)
    err = lib.repro_prim_stream_step(
        X.data_ptr(), aux.data_ptr(), q.data_ptr(), mind.data_ptr(),
        selected.data_ptr(), n, d, _KINDS[(metric, form)], partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prim_stream_step")
    _build.LAUNCHES["prim_stream_step"] += 1
    return mind, out[1:].view(torch.float32)[0], out[0]


def prim_stream_step_batch_cuda(X: torch.Tensor, aux: torch.Tensor,
                                q: torch.Tensor, mind: torch.Tensor,
                                selected: torch.Tensor, *,
                                metric: str = "euclidean",
                                form: str = "gram"):
    """One Prim step of each of b lanes on the card, in one launch pair:
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
    check_metric(metric)
    check_form(form)
    for t, name in ((X, "X"), (aux, "aux"), (q, "q"), (mind, "mind"),
                    (selected, "selected")):
        check_cuda(t, name)
    if X.dtype != torch.float32 or X.dim() != 3 or 0 in X.shape:
        raise ValueError(f"want a non-empty (b, n, d) float32 X, got "
                         f"{X.dtype} {tuple(X.shape)}")
    b, n, d = X.shape
    check_lanes(b)
    if aux.dtype != torch.float32 or mind.dtype != torch.float32 \
            or selected.dtype != torch.bool \
            or not aux.shape == mind.shape == selected.shape == (b, n):
        raise ValueError("want (b, n) float32 aux and mind and (b, n) bool "
                         f"selected for (b, n) = {(b, n)}, got {aux.dtype} "
                         f"{tuple(aux.shape)}, {mind.dtype} "
                         f"{tuple(mind.shape)}, {selected.dtype} "
                         f"{tuple(selected.shape)}")
    if q.shape != (b,) or q.dtype != torch.int64:
        raise ValueError(f"q must be (b,) int64, got {q.dtype} "
                         f"{tuple(q.shape)}")
    lib = _build.library()
    lanes = _build.PRIM_STREAM_LANES
    out = torch.empty((b, 2), dtype=torch.int64, device=X.device)
    partial = (torch.empty(b * -(-n // lanes), dtype=torch.int64,
                           device=X.device) if n > lanes else out)
    err = lib.repro_prim_stream_step_batch(
        X.data_ptr(), aux.data_ptr(), q.data_ptr(), mind.data_ptr(),
        selected.data_ptr(), b, n, d, _KINDS[(metric, form)],
        partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prim_stream_step_batch")
    _build.LAUNCHES["prim_stream_step_batch"] += 1
    return mind, out.view(torch.float32)[:, 2], out[:, 0]


def prim_frontier_step_cuda(X: torch.Tensor, aux: torch.Tensor,
                            table: torch.Tensor, mind: torch.Tensor,
                            slot: torch.Tensor, order: torch.Tensor,
                            edges: torch.Tensor, t: int, *, offset: int = 0,
                            metric: str = "euclidean", form: str = "gram"
                            ) -> torch.Tensor:
    """One step of the sharded engine on this rank's shard, on the card:
    the pivot is the least-key slot of ``table``, recorded as ``order[t]``
    and ``edges[t]``; its lane is closed to +inf if this shard holds it;
    its row is folded into ``mind`` in band, in place; and this rank's next
    slot goes to ``slot``.  ``ref.prim_frontier_round_ref`` is the plain
    version.

    Args:
      X: (n, d) contiguous float32 CUDA tensor — the shard, global ids
        ``offset`` .. ``offset + n - 1``.
      aux: (n,) float32 — ``kernels.ops.metric_aux`` of X.
      table: (P, ref.slot_width(d)) float32 — the gathered slots.
      mind: (n,) float32 — the in-band frontier, updated in place.
      slot: (ref.slot_width(d),) float32 — receives this rank's next slot.
      order, edges: (N,) int64 and float32 — the traversal being recorded.
      t: 0 <= t < N, the pivot's position in the order.
      offset: the global id of the shard's first lane.
      metric: one of ``kernels.ref.METRICS``.
      form: "gram" or "direct".

    Returns:
      ``mind``, updated.
    """
    check_metric(metric)
    check_form(form)
    for tensor, name in ((X, "X"), (aux, "aux"), (table, "table"),
                         (mind, "mind"), (slot, "slot"), (order, "order"),
                         (edges, "edges")):
        check_cuda(tensor, name)
    if X.dtype != torch.float32 or X.dim() != 2 or 0 in X.shape:
        raise ValueError(f"want a non-empty (n, d) float32 X, got {X.dtype} "
                         f"{tuple(X.shape)}")
    n, d = X.shape
    width = slot_width(d)
    if aux.dtype != torch.float32 or mind.dtype != torch.float32 \
            or not aux.shape == mind.shape == (n,):
        raise ValueError(f"want (n,) float32 aux and mind for n = {n}, got "
                         f"{aux.dtype} {tuple(aux.shape)}, {mind.dtype} "
                         f"{tuple(mind.shape)}")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[1] != width or table.shape[0] < 1 \
            or slot.dtype != torch.float32 or slot.shape != (width,):
        raise ValueError(f"want a (P, {width}) float32 table and a ({width},) "
                         f"float32 slot for d = {d}, got {table.dtype} "
                         f"{tuple(table.shape)}, {slot.dtype} "
                         f"{tuple(slot.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("table must start 16-byte aligned")
    if order.dtype != torch.int64 or edges.dtype != torch.float32 \
            or order.dim() != 1 or order.shape != edges.shape \
            or not 0 <= t < order.shape[0]:
        raise ValueError(f"want (N,) int64 order and float32 edges and "
                         f"0 <= t < N, got {order.dtype} "
                         f"{tuple(order.shape)}, {edges.dtype} "
                         f"{tuple(edges.shape)}, t = {t}")
    if not 0 <= offset <= 2 ** 32 - 1 - n:
        raise ValueError(f"global ids offset .. offset + n - 1 must fit 32 "
                         f"bits, got offset = {offset}, n = {n}")
    lib = _build.library()
    lanes = _build.PRIM_STREAM_LANES
    partial = (torch.empty(-(-n // lanes), dtype=torch.int64, device=X.device)
               if n > lanes else None)
    err = lib.repro_prim_frontier_step(
        X.data_ptr(), aux.data_ptr(), table.data_ptr(), table.shape[0],
        width, mind.data_ptr(), n, d, _KINDS[(metric, form)], offset,
        order.data_ptr() + 8 * t, edges.data_ptr() + 4 * t,
        None if partial is None else partial.data_ptr(), slot.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prim_frontier_step")
    _build.LAUNCHES["prim_frontier_step"] += 1
    return mind

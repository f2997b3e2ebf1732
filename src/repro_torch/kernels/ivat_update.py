"""CUDA kernels: the iVAT transform (Havens & Bezdek) of a VAT-ordered
matrix.

The port of ``repro/kernels/ivat_update.py::ivat_from_vat_pallas``.  For any
matrix the recurrence is a path maximum over the tree whose edges join each
row r to its first-index nearest earlier row j_r, with weight w_r; along a
Prim order (no i in (j_r, r) has w_i > w_r) it is the range maximum
D'[a, c] = max(+0, w_{a+1}, .., w_c).  ``csrc/ivat_update.cu`` runs it in
one C call of four launches over all b lanes, with no host sync: the
parents (j, w), a route check a lane, the range writer over tiles for lanes
that passed, and the serial recurrence (one CTA a lane) for lanes that did
not.  Both routes give the recurrence's values; there is no size cap
(``MAX_FUSED_N`` there was a VMEM rule).

``ivat_from_vat_cuda`` is the op.  The stage wrappers (``ivat_parents_cuda``,
``ivat_route_cuda``, ``ivat_range_cuda``, ``ivat_serial_cuda``) launch one
stage each and count no launch: they exist to hold each stage against its
plain version (``ref.ivat_parents_ref``, ``ivat_route_ref``,
``ivat_range_ref``, ``ivat_from_vat_ref``).  ``route_lanes()`` reads how many
lanes took each route since ``reset_route_lanes()``: a counter on the card
that the route kernel adds to, read only when asked.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import check_cuda

#: Lanes per route, one (range, serial) int64 counter on each card used.
_ROUTE_LANES: dict = {}


def route_lanes() -> dict:
    """Lanes that took the range and the serial route since the last
    ``reset_route_lanes``, over every card (waits for the card)."""
    total = [0, 0]
    for counter in _ROUTE_LANES.values():
        total = [a + int(v) for a, v in zip(total, counter.tolist())]
    return {"range": total[0], "serial": total[1]}


def reset_route_lanes() -> None:
    for counter in _ROUTE_LANES.values():
        counter.zero_()


def _route_counter(device: torch.device) -> torch.Tensor:
    counter = _ROUTE_LANES.get(device.index)
    if counter is None:
        counter = torch.zeros(2, dtype=torch.int64, device=device)
        _ROUTE_LANES[device.index] = counter
    return counter


def _stack(rstar: torch.Tensor) -> torch.Tensor:
    """Check the operand; a (b, n, n) view of it."""
    check_cuda(rstar, "rstar")
    if rstar.dtype != torch.float32:
        raise ValueError(f"rstar must be float32, got {rstar.dtype}")
    if rstar.dim() not in (2, 3) or rstar.shape[-1] != rstar.shape[-2] \
            or rstar.shape[-1] == 0:
        raise ValueError(f"want (n, n) or (b, n, n) with n >= 1, got "
                         f"{tuple(rstar.shape)}")
    return rstar[None] if rstar.dim() == 2 else rstar


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _parents(R: torch.Tensor):
    b, n, _ = R.shape
    j = torch.empty((b, n), dtype=torch.int32, device=R.device)
    w = torch.empty((b, n), dtype=torch.float32, device=R.device)
    err = _build.library().repro_ivat_parents(
        R.data_ptr(), j.data_ptr(), w.data_ptr(), b, n, _stream())
    _build.check(err, "ivat_from_vat (parents)")
    return j, w


def _route(j: torch.Tensor, w: torch.Tensor, routes):
    """Flags (b,) int32 (1: range route) and the tables (pre, suf, sparse)
    the range writer reads."""
    b, n = w.shape
    lib = _build.library()
    pre = torch.empty_like(w)
    suf = torch.empty_like(w)
    sparse = torch.empty((b, lib.repro_ivat_sparse_words(n)),
                         dtype=torch.float32, device=w.device)
    flag = torch.empty(b, dtype=torch.int32, device=w.device)
    err = lib.repro_ivat_route(
        j.data_ptr(), w.data_ptr(), pre.data_ptr(), suf.data_ptr(),
        sparse.data_ptr(), flag.data_ptr(),
        None if routes is None else routes.data_ptr(), b, n, _stream())
    _build.check(err, "ivat_from_vat (route)")
    return flag, (pre, suf, sparse)


def _range(w, tables, flag, out) -> None:
    b, n = w.shape
    pre, suf, sparse = tables
    err = _build.library().repro_ivat_range(
        w.data_ptr(), pre.data_ptr(), suf.data_ptr(), sparse.data_ptr(),
        flag.data_ptr(), out.data_ptr(), b, n, _stream())
    _build.check(err, "ivat_from_vat (range)")


def _serial(R, flag, out) -> None:
    b, n, _ = R.shape
    err = _build.library().repro_ivat_serial(
        R.data_ptr(), None if flag is None else flag.data_ptr(),
        out.data_ptr(), b, n, _stream())
    _build.check(err, "ivat_from_vat (serial)")


def ivat_from_vat_cuda(rstar: torch.Tensor) -> torch.Tensor:
    """Geodesic (max-min path) matrix of a VAT-ordered matrix, on the card.

    Args:
      rstar: (n, n) or (b, n, n) contiguous float32 CUDA tensor, n >= 1; a
        Prim order (``core.vat.vat_order``) takes the range route, any
        other matrix the serial recurrence, with the same values
        (``route_lanes`` counts the lanes of each).

    Returns:
      float32 tensor of rstar's shape: D', symmetric with zero diagonal.
      One call is one C call of four launches over all lanes, and counts
      one launch of ``ivat_from_vat``.
    """
    R = _stack(rstar)
    b, n = R.shape[0], R.shape[-1]
    out = torch.empty_like(rstar)
    if b == 0:
        return out
    lib = _build.library()
    scratch = torch.empty(lib.repro_ivat_scratch_words(b, n),
                          dtype=torch.int32, device=R.device)
    err = lib.repro_ivat_from_vat(
        R.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        _route_counter(R.device).data_ptr(), b, n, _stream())
    _build.check(err, "ivat_from_vat")
    _build.LAUNCHES["ivat_from_vat"] += 1
    return out


def ivat_parents_cuda(rstar: torch.Tensor):
    """Stage 1 alone: (j int32, w float32), (n,) or (b, n) as
    ``ref.ivat_parents_ref``."""
    R = _stack(rstar)
    j, w = _parents(R)
    return (j, w) if rstar.dim() == 3 else (j[0], w[0])


def ivat_route_cuda(j: torch.Tensor, w: torch.Tensor):
    """Stage 2 alone on (b, n) parents: (the (b,) bool route flags as
    ``ref.ivat_route_ref``, the tables for ``ivat_range_cuda``)."""
    j, w = j.contiguous(), w.contiguous()
    check_cuda(j, "j")
    check_cuda(w, "w")
    flag, tables = _route(j, w, None)
    return flag.bool(), tables


def ivat_range_cuda(w: torch.Tensor, tables, route: torch.Tensor):
    """Stage 3 alone: (b, n, n) D' of the lanes whose ``route`` is True
    (``ref.ivat_range_ref``); the other lanes are left unwritten."""
    w = w.contiguous()
    check_cuda(w, "w")
    b, n = w.shape
    out = torch.empty((b, n, n), dtype=torch.float32, device=w.device)
    _range(w, tables, route.to(torch.int32), out)
    return out


def ivat_serial_cuda(rstar: torch.Tensor) -> torch.Tensor:
    """The serial route alone, every lane (``ref.ivat_from_vat_ref``)."""
    R = _stack(rstar)
    out = torch.empty_like(rstar)
    if R.shape[0]:
        _serial(R, None, out[None] if out.dim() == 2 else out)
    return out

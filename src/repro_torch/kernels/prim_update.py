"""CUDA kernels: masked first-index argmin for Prim's greedy selection,
and the whole ``vat`` Prim ordering in one launch.

The port of ``repro/kernels/prim_update.py::masked_argmin_pallas``.  The
kernel is ``csrc/prim_update.cu``: one launch, one CTA up to 4,096 lanes,
a packed (value, index) key so the first index wins ties; above that a
second one-CTA pass reduces the per-CTA keys.  The pair is written to a
device buffer and returned as 0-d CUDA tensors, so Prim's loop never waits
on the host.  A (b, n) batch, the counterpart of the reference's vmapped
kernel, is the same launch pair with the lane as a grid axis.

``vat_prim_order_cuda`` runs the loop those argmins drive
(``ref.vat_prim_order_ref``) in one launch: one CTA per matrix keeps the
frontier on chip and takes every step's argmin with the same packed key.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import check_cuda, check_lanes


def masked_argmin_cuda(vals: torch.Tensor, mask: torch.Tensor):
    """(min over lanes where ``mask`` is False, its index), on the card.

    Args:
      vals: (n,) or (b, n) contiguous float32 CUDA tensor, n >= 1, no NaN;
        a (b, n) stack is reduced row by row, 1 <= b <= ``MAX_LANES``.
      mask: bool CUDA tensor of vals' shape; True lanes are excluded.

    Returns:
      (value f32, index int64), 0-d for one vector and (b,) for a stack,
      views of one (b, 2) device buffer; (+inf, 0) where every lane is
      masked.  Row z of a stack equals the call on that row bit for bit.
    """
    check_cuda(vals, "vals")
    check_cuda(mask, "mask")
    if vals.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError(f"want float32 vals and bool mask, got {vals.dtype} "
                         f"and {mask.dtype}")
    if vals.dim() not in (1, 2) or mask.shape != vals.shape \
            or vals.shape[-1] == 0:
        raise ValueError(f"want (n,) or (b, n) vals and mask with n >= 1, "
                         f"got {tuple(vals.shape)} and {tuple(mask.shape)}")
    b = vals.shape[0] if vals.dim() == 2 else 1
    check_lanes(b)
    n = vals.shape[-1]
    lib = _build.library()
    chunk = _build.MASKED_ARGMIN_CHUNK
    out = torch.empty((b, 2), dtype=torch.int64, device=vals.device)
    partial = (torch.empty(b * -(-n // chunk), dtype=torch.int64,
                           device=vals.device) if n > chunk else out)
    err = lib.repro_masked_argmin(
        vals.data_ptr(), mask.data_ptr(), b, n, partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "masked_argmin")
    _build.LAUNCHES["masked_argmin"] += 1
    value = out.view(torch.float32)[:, 2]   # the low half of out[:, 1]
    if vals.dim() == 1:
        return value[0], out[0, 0]
    return value, out[:, 0]


def vat_prim_order_cuda(R: torch.Tensor, i0: torch.Tensor, *,
                        frontier: str | None = None) -> torch.Tensor:
    """Prim's VAT order of R from seed i0, on the card, in one launch.

    Args:
      R: (n, n) or (b, n, n) contiguous finite float32 CUDA tensor, n >= 1,
        1 <= b <= ``MAX_LANES``.
      i0: the seed, int64 on R's device: one element for a matrix, (b,) for
        a stack.
      frontier: "shared" or "global", where the kernel keeps the frontier;
        None chooses by n: shared memory up to
        ``_build.VAT_PRIM_SHARED_MAX_N`` lanes, global scratch above.  Both
        give the same bits.

    Returns:
      (n,) int64 order, or (b, n) for a stack: ``ref.vat_prim_order_ref``'s
      bits, the loop of ``masked_argmin`` steps; lane z equals the call on
      R[z] alone.
    """
    check_cuda(R, "R")
    check_cuda(i0, "i0")
    if R.dtype != torch.float32 or R.dim() not in (2, 3) \
            or R.shape[-1] != R.shape[-2] or R.shape[-1] == 0:
        raise ValueError(f"want a float32 (n, n) or (b, n, n) R with n >= 1, "
                         f"got {R.dtype} {tuple(R.shape)}")
    b = R.shape[0] if R.dim() == 3 else 1
    n = R.shape[-1]
    check_lanes(b)
    if i0.dtype != torch.int64 or i0.numel() != b:
        raise ValueError(f"want {b} int64 seed(s), got {i0.dtype} "
                         f"{tuple(i0.shape)}")
    lib = _build.library()
    if frontier is None:
        frontier = "shared" if n <= _build.VAT_PRIM_SHARED_MAX_N else "global"
    if frontier not in ("shared", "global"):
        raise ValueError(f"frontier must be 'shared' or 'global', got "
                         f"{frontier!r}")
    shared = frontier == "shared"
    if shared and n > _build.VAT_PRIM_SHARED_MAX_N:
        raise ValueError(f"a shared-memory frontier holds at most "
                         f"{_build.VAT_PRIM_SHARED_MAX_N} lanes, got n={n}")
    order = torch.empty((b, n), dtype=torch.int64, device=R.device)
    gmind = gsel = None
    if not shared:
        gmind = torch.empty((b, n), dtype=torch.float32, device=R.device)
        gsel = torch.empty((b, n), dtype=torch.uint8, device=R.device)
    err = lib.repro_vat_prim_order(
        R.data_ptr(), i0.contiguous().data_ptr(), b, n, int(shared),
        0 if gmind is None else gmind.data_ptr(),
        0 if gsel is None else gsel.data_ptr(), order.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "vat_prim_order")
    _build.LAUNCHES["vat_prim_order"] += 1
    return order if R.dim() == 3 else order[0]

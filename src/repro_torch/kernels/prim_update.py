"""CUDA kernel: masked first-index argmin for Prim's greedy selection.

The port of ``repro/kernels/prim_update.py::masked_argmin_pallas``.  The
kernel is ``csrc/prim_update.cu``: one launch, one CTA up to 4,096 lanes,
a packed (value, index) key so the first index wins ties; above that a
second one-CTA pass reduces the per-CTA keys.  The pair is written to a
device buffer and returned as 0-d CUDA tensors, so Prim's loop never waits
on the host.  A (b, n) batch, the counterpart of the reference's vmapped
kernel, is the same launch pair with the lane as a grid axis.
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

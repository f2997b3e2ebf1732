"""CUDA kernel: masked first-index argmin for Prim's greedy selection.

The port of ``repro/kernels/prim_update.py::masked_argmin_pallas``.  The
kernel is ``csrc/prim_update.cu``: one launch, one CTA up to 4,096 lanes,
a packed (value, index) key so the first index wins ties; above that a
second one-CTA pass reduces the per-CTA keys.  The pair is written to a
device buffer and returned as 0-d CUDA tensors, so Prim's loop never waits
on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import check_cuda


def masked_argmin_cuda(vals: torch.Tensor, mask: torch.Tensor):
    """(min over lanes where ``mask`` is False, its index), on the card.

    Args:
      vals: (n,) contiguous float32 CUDA tensor, n >= 1, no NaN.
      mask: (n,) contiguous bool CUDA tensor; True lanes are excluded.

    Returns:
      (value f32 0-d tensor, index int64 0-d tensor), both views of one
      2-element device buffer; (+inf, 0) when every lane is masked.
    """
    check_cuda(vals, "vals")
    check_cuda(mask, "mask")
    if vals.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError(f"want float32 vals and bool mask, got {vals.dtype} "
                         f"and {mask.dtype}")
    if vals.dim() != 1 or mask.shape != vals.shape or vals.numel() == 0:
        raise ValueError(f"want (n,) vals and mask with n >= 1, got "
                         f"{tuple(vals.shape)} and {tuple(mask.shape)}")
    n = vals.numel()
    lib = _build.library()
    chunk = _build.MASKED_ARGMIN_CHUNK
    out = torch.empty(2, dtype=torch.int64, device=vals.device)
    partial = (torch.empty(-(-n // chunk), dtype=torch.int64,
                           device=vals.device) if n > chunk else out)
    err = lib.repro_masked_argmin(
        vals.data_ptr(), mask.data_ptr(), n, partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "masked_argmin")
    _build.LAUNCHES["masked_argmin"] += 1
    return out[1:].view(torch.float32)[0], out[0]

"""CUDA kernel: the iVAT recurrence (Havens & Bezdek) over a VAT-ordered
matrix.

The port of ``repro/kernels/ivat_update.py::ivat_from_vat_pallas``.  The
kernel is ``csrc/ivat_update.cu``: the sequential recurrence loops inside
one CTA per matrix, with D' in global memory.  Unlike the TPU kernel it has
no size cap (``MAX_FUSED_N`` there was a VMEM rule): a CUDA matrix of any
n takes the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import check_cuda


def ivat_from_vat_cuda(rstar: torch.Tensor) -> torch.Tensor:
    """Geodesic (max-min path) matrix of a VAT-ordered matrix, on the card.

    Args:
      rstar: (n, n) or (b, n, n) contiguous float32 CUDA tensor, VAT-ordered
        (``core.vat.vat_order`` order), n >= 1.

    Returns:
      float32 tensor of rstar's shape: D', symmetric with zero diagonal; a
      batch runs one CTA per matrix.
    """
    check_cuda(rstar, "rstar")
    if rstar.dtype != torch.float32:
        raise ValueError(f"rstar must be float32, got {rstar.dtype}")
    if rstar.dim() not in (2, 3) or rstar.shape[-1] != rstar.shape[-2] \
            or rstar.shape[-1] == 0:
        raise ValueError(f"want (n, n) or (b, n, n) with n >= 1, got "
                         f"{tuple(rstar.shape)}")
    n = rstar.shape[-1]
    b = rstar.shape[0] if rstar.dim() == 3 else 1
    out = torch.empty_like(rstar)
    if b == 0:
        return out
    err = _build.library().repro_ivat_from_vat(
        rstar.data_ptr(), out.data_ptr(), b, n,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ivat_from_vat")
    _build.LAUNCHES["ivat_from_vat"] += 1
    return out

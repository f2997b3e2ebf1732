"""Fast-VAT core on PyTorch: the ``vat``, ``ivat`` and ``flashvat`` rungs'
modules.

The user-facing facade with automatic method selection is
``repro_torch.api.FastVAT``; the sampled and approximate rungs of
``repro.core`` are later slices of the port.
"""
from repro_torch.core.bigvat import expand_image
from repro_torch.core.hopkins import hopkins, hopkins_draws, hopkins_from_draws
from repro_torch.core.ivat import ivat, ivat_from_vat
from repro_torch.core.vat import (FlashVATResult, VATResult,
                                  block_structure_score, reorder, vat,
                                  vat_from_dist, vat_matrix_free, vat_order)

__all__ = [
    "vat", "vat_from_dist", "vat_order", "reorder", "VATResult",
    "vat_matrix_free", "FlashVATResult",
    "block_structure_score", "ivat", "ivat_from_vat", "hopkins",
    "hopkins_draws", "hopkins_from_draws", "expand_image",
]

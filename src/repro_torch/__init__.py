"""repro_torch — Fast-VAT on PyTorch, with CUDA kernels for the H100.

The port of ``repro`` (JAX, TPU), package for package.  It imports torch
and numpy and nothing of JAX or of ``repro``.  The supported import
surface lives at the package root:

>>> from repro_torch import FastVAT, assess_tendency, TendencyResult

Attribute access is lazy (PEP 562), so ``import repro_torch`` stays cheap
for consumers that only want a submodule; importing builds no kernel.
"""
from __future__ import annotations

__all__ = [
    "FastVAT", "assess_tendency",
    "TendencyResult", "TendencyReport", "ResultMeta",
    "METRICS", "select_method", "InvalidInput",
    "NumericsPolicy", "NumericsReport",
]

_API_NAMES = frozenset(__all__)


def __getattr__(name: str):
    if name in _API_NAMES:
        from repro_torch import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _API_NAMES)

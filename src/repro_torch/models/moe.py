"""The dense FFN of ``repro/models/moe.py``.

``moe_ffn`` (capacity-based expert dispatch) comes with the moe family
(``ROADMAP.md`` queue 1).  The reference's sharding hints are the identity
without a mesh, so the port has none.
"""
from __future__ import annotations

from repro_torch.models.common import activation


def dense_ffn(p, h, cfg, prefix: str = "w"):
    """Gated (or plain) FFN: h (B,S,D) -> (B,S,D)."""
    act = activation(cfg.act)
    up = h @ p[f"{prefix}_up"]
    if cfg.gated:
        inner = act(h @ p[f"{prefix}_gate"]) * up
    else:
        inner = act(up)
    return inner @ p[f"{prefix}_down"]

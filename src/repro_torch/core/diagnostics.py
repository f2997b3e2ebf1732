"""VAT as a training diagnostic (compat shim).

As ``repro/core/diagnostics.py``: the implementation lives in
``repro_torch.monitor.probes``; this module keeps the original import
surface.

* ``embedding_tendency`` — VAT + Hopkins over a sample of token embeddings.
* ``router_tendency``   — VAT over MoE router logits.
* ``activation_report`` — generic entry point; maximin-sampled and
  Hopkins-bounded, so a report is O(s²) regardless of batch x seq.

New code should import from ``repro_torch.monitor`` directly.
"""
from __future__ import annotations

from repro_torch.monitor.probes import (TendencyReport, activation_report,
                                        embedding_tendency, router_tendency)

__all__ = ["TendencyReport", "activation_report", "embedding_tendency",
           "router_tendency"]

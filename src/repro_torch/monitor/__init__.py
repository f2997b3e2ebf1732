"""Tendency monitoring: probes -> history -> drift.

The port has the reference's ``monitor/drift.py`` (the serving layer's
``drift_window`` feeds it), ``monitor/history.py`` and the array-level
parts of ``monitor/probes.py``: ``ProbeSpec``, ``TendencyTrace``,
``default_probes``, the reports (``activation_report``,
``embedding_tendency``, ``router_tendency``) and the DeepVAT front end
(``encode_batch``, ``model_fingerprint``, ``callable_fingerprint``).
``run_probes`` (the one-program probe tree, which needs the gradient),
``TendencyMonitor`` and ``AUX_NAME`` come with the training stack.
"""
from repro_torch.monitor.drift import (COLLAPSE, OK, STATE_CODES,
                                       STATE_NAMES, STATES, WARN,
                                       DriftConfig, DriftDetector,
                                       worst_state)
from repro_torch.monitor.history import (FIELDS, HISTORY_SCHEMA,
                                         TendencyHistory)
from repro_torch.monitor.probes import (ProbeSpec, TendencyReport,
                                        TendencyTrace, activation_report,
                                        callable_fingerprint,
                                        default_probes, embedding_tendency,
                                        encode_batch, model_fingerprint,
                                        router_tendency)

__all__ = ["COLLAPSE", "OK", "STATE_CODES", "STATE_NAMES", "STATES", "WARN",
           "DriftConfig", "DriftDetector", "worst_state",
           "FIELDS", "HISTORY_SCHEMA", "TendencyHistory",
           "ProbeSpec", "TendencyReport", "TendencyTrace",
           "activation_report", "callable_fingerprint", "default_probes",
           "embedding_tendency", "encode_batch", "model_fingerprint",
           "router_tendency"]

"""Tendency monitoring: the drift state machine over summary streams.

The port has the reference's ``monitor/drift.py`` so far (the serving
layer's ``drift_window`` feeds it); the training-side probes, history and
``TendencyMonitor`` are not ported yet.
"""
from repro_torch.monitor.drift import (COLLAPSE, OK, STATE_CODES,
                                       STATE_NAMES, STATES, WARN,
                                       DriftConfig, DriftDetector,
                                       worst_state)

__all__ = ["COLLAPSE", "OK", "STATE_CODES", "STATE_NAMES", "STATES", "WARN",
           "DriftConfig", "DriftDetector", "worst_state"]

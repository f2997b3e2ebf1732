"""Public API of the port: the facade, the uniform results, the registry.

  facade.py      FastVAT / assess_tendency — data-driven dispatch
  result.py      TendencyResult, ResultMeta (single seed source),
                 TendencyReport
  registry.py    Rung entries + capability flags; select_method
  metrics.py     metric names ("euclidean" ... "precomputed")
  validation.py  InvalidInput admission checks

Most callers want the package root: ``from repro_torch import FastVAT``.
"""
from repro_torch.api import registry
from repro_torch.api.facade import FastVAT, assess_tendency
from repro_torch.api.metrics import COMPUTED_METRICS, METRICS, validate_metric
from repro_torch.api.registry import (MEDIUM_N, SMALL_N, Rung, RungOptions,
                                      get_rung, register, select_method)
from repro_torch.api.result import ResultMeta, TendencyReport, TendencyResult
from repro_torch.api.validation import (MIN_POINTS, InvalidInput,
                                        validate_dissimilarity,
                                        validate_points)
from repro_torch.numerics import NumericsPolicy, NumericsReport

__all__ = [
    "FastVAT", "assess_tendency",
    "TendencyResult", "TendencyReport", "ResultMeta",
    "METRICS", "COMPUTED_METRICS", "validate_metric",
    "Rung", "RungOptions", "register", "get_rung", "registry",
    "select_method", "SMALL_N", "MEDIUM_N",
    "InvalidInput", "MIN_POINTS", "validate_points",
    "validate_dissimilarity",
    "NumericsPolicy", "NumericsReport",
]

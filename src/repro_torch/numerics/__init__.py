"""The numerics shield, ported: the per-fit conditioning pre-pass.

``condition.py`` holds the scale statistics, the Gram-cancellation
condition estimate κ, the isometry-safe conditioning transform, the
``fast | safe | auto`` policy resolution and the bf16 storage
certification — host-side numpy, as in ``repro/numerics/condition.py``.
``certify.py``, the adversarial certification harness, runs fits through
the API layer, so this package root does not import it.
"""
from repro_torch.numerics.condition import (CONDITIONED_METRICS, KAPPA_BF16,
                                            KAPPA_SAFE, ConditionStats,
                                            NumericsPolicy, NumericsReport,
                                            as_policy, condition_stats,
                                            condition_transform,
                                            lb_slack_ulps, resolve)

__all__ = [
    "CONDITIONED_METRICS", "KAPPA_BF16", "KAPPA_SAFE",
    "ConditionStats", "NumericsPolicy", "NumericsReport",
    "as_policy", "condition_stats", "condition_transform",
    "lb_slack_ulps", "resolve",
]

"""Rolling-window drift / collapse detection over probe summaries; the
reference's ``repro/monitor/drift.py``.

One `DriftDetector` per probe consumes the (block_score, k_est, hopkins)
summary stream and maintains an explicit state machine:

  OK       — healthy; within warm-up, or no structural regression.
  WARN     — the EWMA block score has dropped `warn_drop` (relative)
             below its running peak, or the StreamingVAT window over
             recent summaries has split into distinct regimes (the
             summary stream itself became bimodal — a drift signature).
  COLLAPSE — the EWMA block score AND k_est have both fallen below the
             collapse thresholds: the probed stream has lost block
             structure (score -> 0) and merged into one cluster
             (k_est -> 1).

Everything is deterministic in the input sequence (the StreamingVAT
window's reservoir is host numpy, and the window reads only its VAT
image's block score and k_est), so replaying a summary sequence through a
fresh detector reproduces the live states.  The window's queries run on
``device`` (default "cuda": the CUDA kernels; "cpu" their plain PyTorch
versions).
"""
from __future__ import annotations

import dataclasses

OK = "OK"
WARN = "WARN"
COLLAPSE = "COLLAPSE"
STATES = (OK, WARN, COLLAPSE)
# numeric codes for metric dicts (train history stores floats only)
STATE_CODES = {OK: 0.0, WARN: 1.0, COLLAPSE: 2.0}
STATE_NAMES = {v: k for k, v in STATE_CODES.items()}
_SEVERITY = {OK: 0, WARN: 1, COLLAPSE: 2}


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Thresholds for the drift state machine (see module docstring).

    alpha:       EWMA smoothing factor for block_score / k_est.
    min_obs:     observations before any alert can fire (warm-up).
    collapse_block_score / collapse_k_est:
                 COLLAPSE when both EWMAs fall below these.
    warn_drop:   relative EWMA-vs-peak block-score drop that fires WARN.
    warn_floor:  the running peak must exceed this for the drop rule to
                 apply (streams that never had structure can't "drop").
    window:      StreamingVAT reservoir size over summary vectors
                 (0 disables the window detector).
    window_split_score:
                 window block score above which a k>=2 window reading is
                 reported as a regime split (WARN).
    window_min_spread:
                 smallest coordinate range the windowed summaries must
                 span before the split rule applies — block scores are
                 scale-invariant, so a near-constant healthy stream
                 would otherwise read its own noise as two regimes.
    """
    alpha: float = 0.3
    min_obs: int = 3
    collapse_block_score: float = 0.05
    collapse_k_est: float = 1.5
    warn_drop: float = 0.35
    warn_floor: float = 0.15
    window: int = 16
    window_split_score: float = 0.7
    window_min_spread: float = 0.15


class DriftDetector:
    """Streaming drift detector for one probe's summary sequence.

    Args:
      config: the thresholds (defaults: ``DriftConfig()``).
      device: where the StreamingVAT window's queries run; without a GPU
        the default "cuda" raises ``RuntimeError`` when the window is on
        (``config.window > 0``).
    """

    def __init__(self, config: DriftConfig | None = None, *,
                 device="cuda"):
        self.config = config or DriftConfig()
        self.nobs = 0
        self.ewma_score: float | None = None
        self.ewma_k: float | None = None
        self.peak_score = 0.0
        self.state = OK
        self._window = None
        self._recent: list[tuple[float, float, float]] = []
        if self.config.window > 0:
            from repro_torch.core.streaming import StreamingVAT
            self._window = StreamingVAT(self.config.window, 3,
                                        device=device)

    def update(self, block_score: float, k_est: float,
               hopkins: float = 0.5) -> str:
        """Ingest one summary; returns the new state."""
        cfg = self.config
        a = cfg.alpha
        score = float(block_score)
        k = float(k_est)
        self.nobs += 1
        if self.ewma_score is None:
            self.ewma_score, self.ewma_k = score, k
        else:
            self.ewma_score = (1 - a) * self.ewma_score + a * score
            self.ewma_k = (1 - a) * self.ewma_k + a * k
        self.peak_score = max(self.peak_score, self.ewma_score)
        if self._window is not None:
            h = float(hopkins)
            if h != h:  # NaN-safe (e.g. probes without a Hopkins value)
                h = 0.5
            self._window.update([[h, score, k / 8.0]])
            self._recent.append((h, score, k / 8.0))
            del self._recent[:-self.config.window]

        if self.nobs < cfg.min_obs:
            self.state = OK
            return self.state
        if (self.ewma_score < cfg.collapse_block_score
                and self.ewma_k < cfg.collapse_k_est):
            self.state = COLLAPSE
            return self.state
        if (self.peak_score > cfg.warn_floor
                and self.ewma_score < (1 - cfg.warn_drop) * self.peak_score):
            self.state = WARN
            return self.state
        if self._window is not None and len(self._window.pts) >= self.config.window:
            lo = [min(v) for v in zip(*self._recent)]
            hi = [max(v) for v in zip(*self._recent)]
            spread = max(b - a for a, b in zip(lo, hi))
            if spread >= cfg.window_min_spread:
                _, wscore, wk = self._window.tendency()
                if wk >= 2 and wscore > cfg.window_split_score:
                    self.state = WARN
                    return self.state
        self.state = OK
        return self.state


def worst_state(states) -> str:
    """Most severe state in an iterable (OK < WARN < COLLAPSE)."""
    worst = OK
    for s in states:
        if _SEVERITY[s] > _SEVERITY[worst]:
            worst = s
    return worst

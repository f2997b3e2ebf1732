"""Continuous training diagnostics: probes -> history -> drift.

As ``repro/monitor``.  `TendencyMonitor` is the train loop's one-stop
object: each diag step it runs the probe program (``run_probes``: one
program, one host sync), appends per-probe summaries to an append-only
`TendencyHistory` (serialized atomically alongside checkpoints as the
``AUX_NAME`` sidecar), and feeds per-probe `DriftDetector`s whose
OK/WARN/COLLAPSE states surface in the loop's log line.

Determinism: probe i's generator is seeded by (seed, step, i), the
history round-trips bitwise through the checkpoint, and detectors replay
the restored history on resume — an interrupted+resumed run reproduces
the uninterrupted run's history (and drift states) exactly.

The package also holds ``monitor/drift.py`` (the serving layer's
``drift_window`` feeds it), the reports (``activation_report``,
``embedding_tendency``, ``router_tendency``) and the DeepVAT front end
(``encode_batch``, ``model_fingerprint``, ``callable_fingerprint``).
"""
from __future__ import annotations

import warnings

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
                                        probe_dispatch_stats,
                                        router_tendency, run_probes)

AUX_NAME = "tendency_history"


class TendencyMonitor:
    """Probe program + history + drift detectors for one training run.

    ``device`` is where the detectors' StreamingVAT windows run (without a
    GPU the default "cuda" raises ``RuntimeError``); the probes run on the
    params' device.
    """

    def __init__(self, cfg, *, specs=None, drift: DriftConfig | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.specs = tuple(specs) if specs is not None else default_probes(cfg)
        self.seed = int(seed)
        self.device = device
        self.drift_config = drift or DriftConfig()
        self.history = TendencyHistory(tuple(s.name for s in self.specs))
        self.detectors = self._fresh_detectors()

    def _fresh_detectors(self) -> dict:
        return {s.name: DriftDetector(self.drift_config, device=self.device)
                for s in self.specs}

    # ------------------------------------------------------ observe ----

    def observe(self, step: int, params, batch) -> dict:
        """Run one diag step; returns {probe: {field..., "state"}}.

        One program, one host sync; deterministic in (seed, step) so
        resumed runs reproduce uninterrupted ones.
        """
        traces = run_probes(self.cfg, self.specs, params, batch,
                            seed=self.seed, step=int(step))
        summaries = {}
        for spec in self.specs:
            tr = traces[spec.name]
            summaries[spec.name] = {
                "hopkins": float(tr.hopkins),
                "block_score": float(tr.block_score),
                "k_est": float(tr.k_est),
            }
        self.history.append(step, summaries)
        for name, s in summaries.items():
            s["state"] = self.detectors[name].update(
                s["block_score"], s["k_est"], s["hopkins"])
        return summaries

    # ---------------------------------------------------- states ----

    def states(self) -> dict:
        """Current {probe: state} map."""
        return {s.name: self.detectors[s.name].state for s in self.specs}

    def worst_state(self) -> str:
        return worst_state(self.states().values())

    @staticmethod
    def status_line(summaries: dict) -> str:
        """Compact per-probe status string for the train log line."""
        parts = []
        for name, s in summaries.items():
            parts.append(f"{name}={s.get('state', OK)}"
                         f"(score={s['block_score']:.2f},"
                         f"k={s['k_est']:.0f})")
        return " ".join(parts)

    # ------------------------------------------------- persistence ----

    def save_arrays(self) -> dict:
        """aux_arrays payload for `ckpt.save` (history rides the ckpt)."""
        return {AUX_NAME: self.history.to_arrays()}

    def restore(self, ckpt_dir: str, upto_step: int) -> bool:
        """Restore history from a checkpoint dir and replay drift state.

        Truncates to rows <= upto_step (the restored weights' step) and
        replays the rows through fresh detectors, reproducing the live
        states deterministically.  Returns False (and starts fresh) if
        no history was saved or the probe set changed.

        Corruption policy (docs/robustness.md): a sidecar that fails
        strict verification is salvaged via `TendencyHistory.recover` —
        truncate to the last verifiable row, WARN, and resume; only a
        structurally unreadable sidecar (or one with zero verifiable
        rows) falls back to a fresh history.
        """
        from repro_torch.checkpoint import ckpt
        arrays = ckpt.load_aux(ckpt_dir, AUX_NAME)
        if arrays is None:
            return False
        try:
            hist = TendencyHistory.from_arrays(arrays)
        except Exception as exc:  # noqa: BLE001 — recover-and-warn policy
            recovered = TendencyHistory.recover(arrays)
            if recovered is None or len(recovered[0]) == 0:
                warnings.warn(
                    f"[monitor] history sidecar unrecoverable ({exc!r}); "
                    "starting fresh", RuntimeWarning, stacklevel=2)
                return False
            hist, dropped = recovered
            warnings.warn(
                f"[monitor] history sidecar failed verification ({exc!r});"
                f" recovered {len(hist)} rows, dropped {dropped}",
                RuntimeWarning, stacklevel=2)
        if hist.probes != tuple(s.name for s in self.specs):
            return False
        hist.truncate(int(upto_step))
        self.history = hist
        self.detectors = self._fresh_detectors()
        for i in range(len(hist)):
            for name, s in hist.row(i).items():
                self.detectors[name].update(s["block_score"], s["k_est"],
                                            s["hopkins"])
        return True


__all__ = [
    "AUX_NAME", "COLLAPSE", "DriftConfig", "DriftDetector", "FIELDS",
    "HISTORY_SCHEMA", "OK", "ProbeSpec", "STATES", "STATE_CODES",
    "STATE_NAMES", "TendencyHistory", "TendencyMonitor", "TendencyReport",
    "TendencyTrace", "WARN", "activation_report", "callable_fingerprint",
    "default_probes", "embedding_tendency", "encode_batch",
    "model_fingerprint", "probe_dispatch_stats", "router_tendency",
    "run_probes", "worst_state",
]

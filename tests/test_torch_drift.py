"""The port's drift state machine held against the JAX package's, on the
CPU.

The reference's drift cases (``tests/test_monitor.py``: the collapse
trajectory, a healthy stream, the relative drop, ``worst_state``) run
against ``repro_torch.monitor.drift``; then the same summary sequences go
through both packages' ``DriftDetector`` and must give the same states
step by step, the StreamingVAT window included.  The window reads only
its reservoir's block score and k_est: the reservoir is host numpy in
both packages and the port holds it bit for bit
(tests/test_torch_streaming.py), so the states agree exactly; the Hopkins draws, which differ,
never reach a state.
"""
import numpy as np
import pytest

from repro.monitor import drift as jdrift
from repro_torch.monitor import (COLLAPSE, OK, STATE_CODES, STATE_NAMES,
                                 STATES, WARN, DriftConfig, DriftDetector,
                                 worst_state)

CPU = "cpu"


def _detector(config=None):
    return DriftDetector(config or DriftConfig(), device=CPU)


def test_drift_collapse_trajectory():
    """score 0.8 -> 0, k 5 -> 1 passes through WARN and ends in
    COLLAPSE."""
    det = _detector()
    states = []
    for i in range(20):
        t = i / 19.0
        states.append(det.update(0.8 * (1 - t) ** 2, 5.0 - 4.0 * t, 0.7))
    assert states[-1] == COLLAPSE
    assert WARN in states
    assert states[0] == OK


def test_drift_healthy_trajectory_stays_ok():
    rng = np.random.default_rng(0)
    det = _detector()
    states = [det.update(0.75 + 0.03 * rng.standard_normal(), 5.0, 0.8)
              for _ in range(40)]
    assert set(states) == {OK}


def test_drift_warn_on_relative_drop_without_collapse():
    det = _detector()
    for _ in range(6):
        det.update(0.8, 5.0, 0.8)
    state = OK
    for _ in range(12):
        state = det.update(0.3, 5.0, 0.8)
    assert state == WARN


def test_worst_state_ordering():
    assert worst_state([OK, OK]) == OK
    assert worst_state([OK, WARN]) == WARN
    assert worst_state([WARN, COLLAPSE, OK]) == COLLAPSE


def test_state_codes_are_the_reference_codes():
    assert STATES == jdrift.STATES
    assert STATE_CODES == jdrift.STATE_CODES
    assert STATE_NAMES == jdrift.STATE_NAMES
    assert DriftConfig() == DriftConfig(**vars(jdrift.DriftConfig()))


def test_default_device_window_needs_a_gpu():
    """The window's queries default to the card; without one the detector
    raises unless the caller asks for the CPU (a window of 0 needs
    none)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        DriftDetector()
    assert DriftDetector(DriftConfig(window=0)).update(0.5, 2.0) == OK


def _sequence(kind, seed, steps=48):
    """A summary stream (block_score, k_est, hopkins) of one kind."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        t = i / (steps - 1)
        if kind == "collapse":
            s, k = 0.8 * (1 - t) ** 2, 5.0 - 4.0 * t
        elif kind == "healthy":
            s, k = 0.75 + 0.03 * rng.standard_normal(), 5.0
        elif kind == "regimes":            # two alternating regimes
            s, k = (0.8, 5.0) if (i // 6) % 2 == 0 else (0.45, 2.0)
        elif kind == "split":              # regimes alternating fast
            s, k = (0.8, 5.0) if (i // 2) % 2 == 0 else (0.45, 2.0)
        elif kind == "drop":
            s, k = (0.8 if i < 10 else 0.3), 5.0
        else:                               # noise
            s, k = float(rng.uniform(0, 1)), float(rng.integers(1, 8))
        h = {"nan": float("nan"), "split": 0.7}.get(
            kind, float(rng.uniform(0.4, 0.95)))
        out.append((s, k, h))
    return out


@pytest.mark.parametrize("window", [0, 8, 16])
@pytest.mark.parametrize("kind", ["collapse", "healthy", "regimes", "split",
                                  "drop", "noise", "nan"])
@pytest.mark.parametrize("seed", [0, 1])
def test_states_match_reference(kind, seed, window):
    """The same summary sequence through both detectors gives the same
    state at every step, and the same EWMAs and peak."""
    cfg = dict(window=window)
    got = _detector(DriftConfig(**cfg))
    want = jdrift.DriftDetector(jdrift.DriftConfig(**cfg))
    for s, k, h in _sequence(kind, seed):
        assert got.update(s, k, h) == want.update(s, k, h)
        assert (got.nobs, got.ewma_score, got.ewma_k, got.peak_score) == \
            (want.nobs, want.ewma_score, want.ewma_k, want.peak_score)
    if window:
        np.testing.assert_array_equal(got._window.pts,
                                      np.asarray(want._window.pts))


def test_window_split_rule_fires_on_two_regimes():
    """A bimodal summary stream (without an EWMA drop past warn_drop)
    reads WARN from the window's regime split in both packages."""
    cfg = dict(window=8, warn_drop=0.9)
    got = _detector(DriftConfig(**cfg))
    want = jdrift.DriftDetector(jdrift.DriftConfig(**cfg))
    states = []
    for s, k, h in _sequence("split", 0):
        states.append(got.update(s, k, h))
        assert states[-1] == want.update(s, k, h)
    assert WARN in states

"""The port's checkpoints held on the CPU against the JAX package.

* The npz key names of a whole ``TrainState`` (AdamW; Adafactor with and
  without momentum, with error feedback) equal the reference's, in its
  order, with its shapes and dtypes.
* A checkpoint written by the reference restores in the port, and one
  written by the port restores in the reference, leaf for leaf bit for
  bit (bf16 moments included), after a step of each package's own.
* The reference's checkpoint cases: round trip and GC, no partial
  publish; its sidecar cases through the port's ``ckpt.aux_write`` and
  ``ckpt.aux_read`` fault sites (``tests/test_recovery.py``); and the
  monitor's recovery from a poisoned or torn sidecar.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.train import steps as JS
from repro_torch import configs, faults
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CorruptSidecar
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.monitor import AUX_NAME, TendencyHistory, TendencyMonitor
from repro_torch.train import steps as S
from repro_torch.train.loop import train

CPU = "cpu"
SHAPE = ShapeConfig("tiny", 32, 4, "train")
OPTIMIZERS = {"adamw": {}, "adafactor": {"optimizer": "adafactor"},
              "adafactor_b1_0_ef": {"optimizer": "adafactor", "b1": 0.0,
                                    "compress_grads": True}}


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.disarm_all()
    yield
    faults.disarm_all()


def _history(steps=(2, 4, 6, 8, 10), probes=("p", "q")):
    h = TendencyHistory(probes)
    for i, s in enumerate(steps):
        h.append(s, {p: {"hopkins": 0.5 + 0.01 * i + 0.1 * j,
                         "block_score": 0.4 + 0.02 * i,
                         "k_est": float(2 + (i + j) % 3)}
                     for j, p in enumerate(probes)})
    return h


def _truncated_digest(h, keep_rows):
    ref = TendencyHistory.from_arrays(h.to_arrays())
    ref.truncate(h.steps[keep_rows - 1] if keep_rows else -1)
    return ref.digest()


def _tc(tmpdir, **kw):
    kw.setdefault("lr", 1e-2)
    kw.setdefault("total_steps", 8)
    kw.setdefault("ckpt_every", 4)
    kw.setdefault("diag_every", 2)
    return TrainConfig(ckpt_dir=str(tmpdir), **kw)


# ------------------------------------------------- the reference's keys ----


@functools.lru_cache(maxsize=None)
def _states(opt):
    """A reference TrainState and a port one of the same config, each
    after one step of its own package (so every moment is non-zero)."""
    kw = OPTIMIZERS[opt]
    name = "gemma-2b"
    jcfg, tcfg = jconfigs.smoke_config(name), configs.smoke_config(name)
    jtc, ttc = jbase.TrainConfig(lr=1e-2, **kw), TrainConfig(lr=1e-2, **kw)
    want = jtokens.make_batch(jcfg, jbase.ShapeConfig("t", 16, 2, "train"))
    js = JS.init_state(jcfg, jtc, jax.random.PRNGKey(0))
    js, _ = jax.jit(JS.build_train_step(jcfg, jtc))(
        js, {k: jnp.asarray(v) for k, v in want.items()})
    ts = S.init_state(tcfg, ttc, torch.Generator().manual_seed(0),
                      device=CPU)
    ts, _ = S.build_train_step(tcfg, ttc)(ts, dict(want))
    return js, ts


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_keys_are_the_references(opt):
    js, ts = _states(opt)
    want, got = jckpt._flatten(js), ckpt._flatten(ts)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    assert ".opt/.step" in got and ".params/embed" in got
    if opt == "adamw":
        assert ".opt/.v/layers/w_up" in got
    else:
        assert ".opt/.v/layers/w_up/0" in got
        assert ".opt/.v/layers/w_up/1" in got
    momentum_free = opt == "adafactor_b1_0_ef"
    assert any(k.startswith(".opt/.m/") for k in got) != momentum_free
    assert any(k.startswith(".ef/") for k in got) == momentum_free


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_reference_checkpoint_restores_in_the_port(tmp_path, opt):
    js, ts = _states(opt)
    jckpt.save(str(tmp_path), 1, js)
    got, manifest = ckpt.restore(str(tmp_path), ts)
    assert manifest["step"] == 1
    want = jckpt._flatten(js)
    flat = ckpt._flatten(got)
    assert list(flat) == list(want)
    for path, leaf in ckpt._walk(got):
        tmpl = dict(ckpt._walk(ts))[path]
        assert leaf.dtype == tmpl.dtype and leaf.device == tmpl.device
        np.testing.assert_array_equal(flat[path], want[path])
    if got.opt.m is not None and opt != "adamw":
        assert got.opt.m["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_port_checkpoint_restores_in_the_reference(tmp_path, opt):
    js, ts = _states(opt)
    ckpt.save(str(tmp_path), 1, ts)
    got, manifest = jckpt.restore(str(tmp_path), js)
    assert manifest["step"] == 1
    want = ckpt._flatten(ts)
    for (kp, leaf), (kt, tmpl) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(js)[0]):
        assert leaf.dtype == tmpl.dtype
    flat = jckpt._flatten(got)
    assert list(flat) == list(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])


# ----------------------------------------------- the reference's cases ----


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_00000004", "step_00000005"]  # GC kept last 2
    got, manifest = ckpt.restore(str(tmp_path), tree)
    assert manifest["step"] == 5
    assert torch.equal(got["a"], torch.arange(6).reshape(2, 3))
    assert got["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_no_partial_publish(tmp_path):
    """A tmp.<step> dir must never be visible as a restorable checkpoint."""
    tree = {"w": torch.zeros((8,))}
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "tmp.999", exist_ok=True)  # simulated crash debris
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_restore_refuses_a_shape_mismatch(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros((8,))})
    with pytest.raises(ValueError, match="w: ckpt"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros((4,))})
    assert ckpt.restore(str(tmp_path / "none"), {"w": torch.zeros(8)}) \
        == (None, None)


# ================================================== checkpoint sidecar ==

def _save_with_history(tmp_path, step=4, arrays=None):
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    arrays = arrays if arrays is not None else _history().to_arrays()
    ckpt.save(str(tmp_path), step, tree, aux_arrays={AUX_NAME: arrays})
    return arrays


def test_sidecar_roundtrip_clean(tmp_path):
    _save_with_history(tmp_path)
    back = ckpt.load_aux(str(tmp_path), AUX_NAME)
    assert TendencyHistory.from_arrays(back).steps == [2, 4, 6, 8, 10]


def test_missing_sidecar_returns_none(tmp_path):
    ckpt.save(str(tmp_path), 4, {"w": torch.zeros(3)})
    assert ckpt.load_aux(str(tmp_path), AUX_NAME) is None


def test_truncated_sidecar_recovered(tmp_path):
    with faults.injected("ckpt.aux_write", kind="truncate"):
        _save_with_history(tmp_path)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert ckpt.load_aux(str(tmp_path), AUX_NAME) is None
    with pytest.raises(CorruptSidecar):
        ckpt.load_aux(str(tmp_path), AUX_NAME, strict=True)


def test_byte_flipped_sidecar_recovered(tmp_path):
    with faults.injected("ckpt.aux_write", kind="corrupt", seed=11):
        _save_with_history(tmp_path)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert ckpt.load_aux(str(tmp_path), AUX_NAME) is None


def test_read_fault_recovered_and_strict(tmp_path):
    _save_with_history(tmp_path)
    with faults.injected("ckpt.aux_read", exc=OSError, times=-1,
                         message="injected I/O error"):
        with pytest.warns(RuntimeWarning, match="unreadable"):
            assert ckpt.load_aux(str(tmp_path), AUX_NAME) is None
        with pytest.raises(CorruptSidecar, match="unreadable"):
            ckpt.load_aux(str(tmp_path), AUX_NAME, strict=True)
    assert ckpt.load_aux(str(tmp_path), AUX_NAME) is not None  # disarmed


def test_weights_survive_sidecar_corruption(tmp_path):
    """The recovery policy's whole point: a torn sidecar never blocks
    restoring the weights checkpoint it rides with."""
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    with faults.injected("ckpt.aux_write", kind="truncate"):
        ckpt.save(str(tmp_path), 4, tree,
                  aux_arrays={AUX_NAME: _history().to_arrays()})
    restored, manifest = ckpt.restore(str(tmp_path),
                                      {"w": torch.zeros(6)})
    assert manifest["step"] == 4
    assert torch.equal(restored["w"], tree["w"])


def test_sidecar_sites_count_their_hits(tmp_path):
    with faults.injected("ckpt.aux_write", times=0), \
            faults.injected("ckpt.aux_read", times=0):
        _save_with_history(tmp_path)
        ckpt.load_aux(str(tmp_path), AUX_NAME)
        stats = faults.stats()
    assert stats["ckpt.aux_write"]["hits"] == 1
    assert stats["ckpt.aux_read"]["hits"] == 1


# ================================================== monitor recovery ====


def test_monitor_restore_recovers_verifiable_prefix(tmp_path):
    cfg = configs.smoke_config("gemma-2b")
    mon = TendencyMonitor(cfg, device=CPU)
    probes = tuple(s.name for s in mon.specs)
    good = _history(steps=(2, 4, 6), probes=probes)
    arrays = good.to_arrays()
    col = f"{probes[0]}/hopkins"
    arrays[col] = arrays[col].copy()
    arrays[col][2] += np.float32(1.0)             # poison the last row
    _save_with_history(tmp_path, step=6, arrays=arrays)
    with pytest.warns(RuntimeWarning, match="recovered 2 rows, dropped 1"):
        assert mon.restore(str(tmp_path), upto_step=6)
    assert mon.history.steps == [2, 4]
    assert mon.history.digest() == _truncated_digest(good, 2)
    assert set(mon.states()) == set(probes)       # detectors replayed


def test_monitor_restore_unrecoverable_starts_fresh(tmp_path):
    cfg = configs.smoke_config("gemma-2b")
    mon = TendencyMonitor(cfg, device=CPU)
    probes = tuple(s.name for s in mon.specs)
    arrays = _history(steps=(2, 4), probes=probes).to_arrays()
    arrays["row_check"] = arrays["row_check"].copy()
    arrays["row_check"][:] ^= np.uint64(1)        # no verifiable prefix
    _save_with_history(tmp_path, step=4, arrays=arrays)
    with pytest.warns(RuntimeWarning, match="unrecoverable"):
        assert not mon.restore(str(tmp_path), upto_step=4)
    assert len(mon.history) == 0


def test_train_resume_survives_corrupt_sidecar(tmp_path):
    """Degradation, not collapse: a resumed run whose history sidecar
    was torn on disk restarts the history fresh and still completes."""
    cfg = configs.smoke_config("gemma-2b")
    with pytest.raises(KeyboardInterrupt):
        train(cfg, _tc(tmp_path), SHAPE, log=lambda s: None, interrupt_at=5,
              device=CPU)
    step = ckpt.latest_step(str(tmp_path))
    assert step == 4
    sidecar = f"{tmp_path}/step_{step:08d}/{AUX_NAME}.npz"
    with open(sidecar, "r+b") as f:               # tear it mid-file
        f.truncate(200)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        _, hist = train(cfg, _tc(tmp_path), SHAPE, log=lambda s: None,
                        device=CPU)
    saved = ckpt.load_aux(str(tmp_path), AUX_NAME)
    assert saved is not None
    resumed = TendencyHistory.from_arrays(saved)
    assert resumed.steps == [6, 8]                # fresh past the tear
    assert len(hist) == 4

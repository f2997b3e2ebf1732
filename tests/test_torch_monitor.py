"""The port's monitor history and array-level probes held on the CPU
against the JAX package.

* ``TendencyHistory``: the reference's append-only and round-trip case;
  the two packages read each other's arrays with equal ``digest``; a
  sidecar corrupted through the port's ``history.deserialize`` fault site
  is refused by ``from_arrays`` and salvaged by ``recover`` to the
  reference's rows.
* ``ProbeSpec`` validation and ``default_probes`` for every arch.
* The reports (``tests/test_core_extra.py``'s diagnostics cases by their
  bars), and ``_trace_parts_from`` fed the reference's own draws on
  integer activations: the sample, ``k_est`` and rstar's order equal,
  rstar and the block score within an ulp of f32 (torch's CPU ``sqrt``
  may be an ulp off numpy's), Hopkins in (0, 1) (its probes are drawn by
  each package's generator).
* ``model_fingerprint`` and ``callable_fingerprint``: the reference's
  strings for the same weights and the same function.
* The training side: ``run_probes``'s selected arrays (taps, router
  logits, the embedding table, gradient leaves) against the reference's
  within 2e-5 of scale, its traces ``_trace_parts`` of them with the
  generator of (seed, step, probe index); the reference's monitor cases
  on the port's loop (``train(device="cpu")``): the history bit for bit
  after an interrupt and resume, per-probe metrics surfaced, one diag
  step one program, ``observe`` deterministic in (seed, step).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import faults as jfaults
from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.train import steps as JS
from repro.core.svat import maximin_sample as jmaximin
from repro.models import model as JM
from repro.monitor import history as jhistory
from repro.monitor import probes as jprobes
from repro_torch import configs, core, faults
from repro_torch.models import model as M
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.tokens import make_batch
from repro_torch.monitor import (AUX_NAME, FIELDS, HISTORY_SCHEMA, ProbeSpec,
                                 TendencyHistory, TendencyMonitor,
                                 TendencyTrace, activation_report,
                                 callable_fingerprint, default_probes,
                                 model_fingerprint, probe_dispatch_stats,
                                 run_probes)
from repro_torch.monitor import probes as tprobes
from repro_torch.monitor.probes import _trace_parts, _trace_parts_from
from repro_torch.train.loop import train

CPU = "cpu"
F32_ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    faults.disarm_all()
    jfaults.disarm_all()


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator(device=CPU).manual_seed(seed)


def _rows(cls, probes=("p", "q"), steps=(2, 4, 6, 8, 10)):
    h = cls(probes)
    rng = np.random.default_rng(0)
    for s in steps:
        h.append(s, {p: {"hopkins": rng.random(), "block_score": rng.random(),
                         "k_est": float(rng.integers(1, 9))}
                     for p in probes})
    return h


# ------------------------------------------------------------ history ----


def test_history_append_only_and_roundtrip():
    """The counterpart of tests/test_monitor.py::
    test_history_append_only_and_roundtrip."""
    h = TendencyHistory(("p", "q"))
    row = {"p": {"hopkins": 0.7, "block_score": 0.5, "k_est": 3.0},
           "q": {"hopkins": 0.6, "block_score": 0.4, "k_est": 2.0}}
    h.append(10, row)
    with pytest.raises(ValueError):            # non-increasing step
        h.append(10, row)
    with pytest.raises(ValueError):            # missing probe
        h.append(20, {"p": row["p"]})
    h.append(20, row)
    back = TendencyHistory.from_arrays(h.to_arrays())
    assert back.steps == [10, 20]
    assert back.digest() == h.digest()
    back.truncate(10)
    assert back.steps == [10]
    assert back.digest() != h.digest()
    bad = h.to_arrays()
    bad["schema"] = np.asarray([99], np.int64)
    with pytest.raises(ValueError):
        TendencyHistory.from_arrays(bad)
    with pytest.raises(ValueError):
        TendencyHistory(())


def test_history_reads_the_references_arrays_and_back():
    assert HISTORY_SCHEMA == jhistory.HISTORY_SCHEMA
    assert FIELDS == jhistory.FIELDS
    ref = _rows(jhistory.TendencyHistory)
    port = TendencyHistory.from_arrays(ref.to_arrays())
    assert port.digest() == ref.digest()
    assert port.steps == ref.steps and port.probes == ref.probes
    assert port.row(3) == ref.row(3)
    assert port.nbytes_per_step() == ref.nbytes_per_step()
    mine, theirs = _rows(TendencyHistory).to_arrays(), ref.to_arrays()
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    back = jhistory.TendencyHistory.from_arrays(port.to_arrays())
    assert back.digest() == port.digest()


def test_history_recovers_a_sidecar_corrupted_at_the_fault_site():
    h = _rows(TendencyHistory)
    arrays = h.to_arrays()
    keys = sorted(arrays)
    seed = keys.index("p/block_score")            # target a field column
    with faults.injected("history.deserialize", kind="corrupt", seed=seed):
        with pytest.raises(ValueError, match="mismatch"):
            TendencyHistory.from_arrays(arrays)
    # the fault mutated from_arrays' private copy, not the caller's dict
    assert TendencyHistory.from_arrays(arrays).digest() == h.digest()
    # the same fault at the same site hands recover the corrupted payload
    with faults.injected("history.deserialize", kind="corrupt", seed=seed):
        bad = faults.fault_point("history.deserialize", data=dict(arrays))
    with jfaults.injected("history.deserialize", kind="corrupt", seed=seed):
        jbad = jfaults.fault_point("history.deserialize", data=dict(arrays))
    for k in bad:
        np.testing.assert_array_equal(bad[k], jbad[k])
    got, dropped = TendencyHistory.recover(bad)
    want, jdropped = jhistory.TendencyHistory.recover(jbad)
    assert 0 < dropped == jdropped < len(h)
    assert got.steps == want.steps == h.steps[:len(h) - dropped]
    assert got.digest() == want.digest()
    assert TendencyHistory.recover({"probes": np.asarray([])}) is None


# -------------------------------------------------------------- specs ----


def test_probe_spec_validation():
    with pytest.raises(ValueError, match="unknown probe kind"):
        ProbeSpec("x", "weights")
    spec = ProbeSpec("p", "layer", layer=-2, sample=32, thumbnail=4)
    assert (spec.kind, spec.layer, spec.target) == ("layer", -2, "embed")
    with pytest.raises(AttributeError):
        spec.sample = 8                          # frozen
    tr = TendencyTrace(hopkins=torch.tensor(0.8), block_score=torch.tensor(
        0.5), k_est=torch.tensor(3), thumbnail=None, spec=spec)
    assert tr.spec == spec


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_default_probes_match_reference(name):
    for sample, thumb in ((128, 0), (64, 8)):
        got = default_probes(configs.get_config(name), sample=sample,
                             thumbnail=thumb)
        want = jprobes.default_probes(jconfigs.get_config(name),
                                      sample=sample, thumbnail=thumb)
        assert [vars(s) for s in got] == [vars(s) for s in want]


# ------------------------------------------------------------ reports ----


def test_diagnostics_report_shapes_and_ranges():
    """The counterpart of tests/test_core_extra.py::
    test_diagnostics_report_shapes_and_ranges, through repro_torch.core."""
    rng = np.random.default_rng(0)
    acts = torch.tensor(np.concatenate([rng.normal(size=(100, 8)),
                                        rng.normal(size=(100, 8)) + 8]),
                        dtype=torch.float32)
    rep = core.activation_report(acts, _gen(), sample=64)
    assert 0.0 <= float(rep.hopkins) <= 1.0
    assert 0.0 <= float(rep.block_score) <= 1.0
    assert rep.rstar.shape == (64, 64)
    assert int(rep.k_est) >= 2
    # any leading shape is flattened to rows
    rep3 = core.activation_report(acts.reshape(4, 50, 8), _gen(), sample=64)
    assert torch.equal(rep3.rstar, rep.rstar)


def test_router_collapse_detection():
    """The counterpart of tests/test_core_extra.py::
    test_router_collapse_detection, through repro_torch.core."""
    rng = np.random.default_rng(0)
    collapsed = torch.tensor(rng.normal(size=(1, 16))
                             + 0.01 * rng.normal(size=(256, 16)),
                             dtype=torch.float32)
    healthy = torch.tensor(np.concatenate(
        [rng.normal(size=(64, 16)) + 6 * np.eye(16)[i % 16]
         for i in range(4)]), dtype=torch.float32)
    rc = core.router_tendency(collapsed, _gen())
    rh = core.router_tendency(healthy, _gen())
    assert float(rh.block_score) > float(rc.block_score)
    emb = core.embedding_tendency(healthy, _gen(), sample=32)
    assert emb.rstar.shape == (32, 32)


@pytest.mark.parametrize("n,sample,cap", [(300, 32, 0), (90, 128, 0),
                                          (400, 24, 50)])
def test_trace_parts_from_the_references_draws(n, sample, cap):
    rng = np.random.default_rng(n)
    centers = rng.integers(-40, 40, size=(4, 6))
    acts = (centers[rng.integers(0, 4, size=n)]
            + rng.integers(-3, 4, size=(n, 6))).astype(np.float32)
    key = jax.random.PRNGKey(n)
    want = jprobes._trace_parts(jnp.asarray(acts), key, sample=sample,
                                thumbnail=8, hopkins_cap=cap)
    k_s, _, k_u = jax.random.split(key, 3)
    s = min(sample, n)
    i0 = int(np.asarray(jmaximin(jnp.asarray(acts), s, k_s))[0])
    cap_ = cap if cap > 0 else 4 * s
    hrows = None
    if n > cap_:
        hrows = torch.as_tensor(np.array(
            jax.random.choice(k_u, n, (cap_,), replace=False)))
    h, score, k_est, rstar, thumb = _trace_parts_from(
        torch.from_numpy(acts), i0, hrows, _gen(), sample=sample,
        thumbnail=8)
    np.testing.assert_allclose(rstar.numpy(), np.asarray(want[3]),
                               rtol=2 * F32_ULP, atol=0)
    assert int(k_est) == int(want[2])
    assert abs(float(score) - float(want[1])) <= 8 * F32_ULP
    np.testing.assert_allclose(thumb.numpy(), np.asarray(want[4]),
                               rtol=2 * F32_ULP, atol=0)
    assert 0.0 < float(h) < 1.0 and 0.0 < float(want[0]) < 1.0
    # the generator's three draws: start, subsample, probes
    full = _trace_parts(torch.from_numpy(acts), _gen(7), sample=sample,
                        thumbnail=0, hopkins_cap=cap)
    g = _gen(7)
    j0 = torch.randint(0, n, (), generator=g)
    rows = torch.randperm(n, generator=g)[:cap_] if n > cap_ else None
    again = _trace_parts_from(torch.from_numpy(acts), j0, rows, g,
                              sample=sample, thumbnail=0)
    assert all(torch.equal(a, b) for a, b in zip(full[:4], again[:4]))


def test_activation_report_matches_maximin_sample_image():
    """The report's rstar is the VAT image of core.maximin_sample's rows
    drawn from a generator of the same seed, bit for bit."""
    rng = np.random.default_rng(3)
    acts = torch.tensor(rng.normal(size=(500, 12)), dtype=torch.float32)
    rep = activation_report(acts, _gen(11), sample=40)
    idx = core.maximin_sample(acts, 40, _gen(11))
    from repro_torch.kernels import ops
    want = core.vat_from_dist(ops.pairwise_dist(acts[idx])).rstar
    assert torch.equal(rep.rstar, want)


# ------------------------------------------------------- fingerprints ----


@pytest.mark.parametrize("name", ["gemma-2b", "internvl2-1b"])
def test_model_fingerprint_is_the_references(name):
    cfg = jconfigs.smoke_config(name)
    jp = JM.init_params(cfg, jax.random.PRNGKey(3))
    tp = M.params_from_numpy(jax.device_get(jp), device=CPU)
    tcfg = configs.smoke_config(name)
    got = model_fingerprint(tcfg, tp)
    assert got == jprobes.model_fingerprint(cfg, jp)
    assert got.startswith(f"{name}@")
    other = M.params_from_numpy(jax.device_get(
        JM.init_params(cfg, jax.random.PRNGKey(4))), device=CPU)
    assert model_fingerprint(tcfg, other) != got


def test_callable_fingerprint_is_the_references():
    def encoder(x):
        return x * 2

    assert callable_fingerprint(encoder) == \
        jprobes.callable_fingerprint(encoder)
    assert "encoder@" in callable_fingerprint(encoder)
    layer = torch.nn.Identity()                    # no __code__
    assert callable_fingerprint(layer) == jprobes.callable_fingerprint(layer)


# ------------------------------------------------- the training side ----

SHAPE = ShapeConfig("tiny", 32, 4, "train")


def _tc(tmpdir, **kw):
    kw.setdefault("lr", 1e-2)
    kw.setdefault("total_steps", 8)
    kw.setdefault("ckpt_every", 4)
    kw.setdefault("diag_every", 2)
    return TrainConfig(ckpt_dir=str(tmpdir), **kw)


def _saved_history(ckpt_dir):
    arrays = ckpt.load_aux(str(ckpt_dir), AUX_NAME)
    assert arrays is not None, "checkpoint should carry a tendency sidecar"
    return TendencyHistory.from_arrays(arrays)


def test_history_bitwise_identical_after_interrupt_resume(tmp_path):
    """The counterpart of tests/test_monitor.py's acceptance pin: a killed
    and resumed run serializes the same history (digest over schema,
    probes, steps and field bytes) as an uninterrupted run."""
    cfg = configs.smoke_config("gemma-2b")
    a, b = tmp_path / "a", tmp_path / "b"
    train(cfg, _tc(a), SHAPE, log=lambda s: None, device=CPU)
    with pytest.raises(KeyboardInterrupt):
        train(cfg, _tc(b), SHAPE, log=lambda s: None, interrupt_at=5,
              device=CPU)
    train(cfg, _tc(b), SHAPE, log=lambda s: None, device=CPU)
    ha, hb = _saved_history(a), _saved_history(b)
    assert ha.steps == [2, 4, 6, 8]
    assert ha.steps == hb.steps
    assert ha.probes == hb.probes
    assert ha.digest() == hb.digest()


def test_train_loop_surfaces_per_probe_metrics(tmp_path):
    cfg = configs.smoke_config("gemma-2b")
    logs = []
    _, hist = train(cfg, _tc(tmp_path), SHAPE, log=logs.append, device=CPU)
    diag = [h for h in hist if "vat_block_score" in h]
    assert len(diag) == 4                      # steps 2, 4, 6, 8
    row = diag[-1]
    for name in ("embed_table", "acts_final", "grad_embed"):
        for field in ("block_score", "k_est", "hopkins", "state"):
            assert f"tendency/{name}/{field}" in row
    # legacy keys are fed from the embedding probe
    assert row["vat_block_score"] == row["tendency/embed_table/block_score"]
    assert any("[tendency]" in line for line in logs)


def _model(name="gemma-2b", seed=0):
    cfg = configs.smoke_config(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=CPU)
    return cfg, params, make_batch(cfg, SHAPE, device=CPU)


def test_one_diag_step_is_one_program():
    """A diag step builds exactly one probe program; observing again with
    the same (cfg, specs) runs warm — no new program, no new trace."""
    cfg, params, batch = _model()
    # unique sample size => fresh lru_cache entry even across test runs
    specs = default_probes(cfg, sample=37)
    mon = TendencyMonitor(cfg, specs=specs, seed=3, device=CPU)
    before = probe_dispatch_stats()
    mon.observe(1, params, batch)
    after_first = probe_dispatch_stats()
    assert after_first["programs"] - before["programs"] == 1
    assert after_first["traces"] - before["traces"] == 1
    mon.observe(2, params, batch)
    assert probe_dispatch_stats() == after_first   # warm: nothing moved
    assert len(mon.history) == 2


def test_observe_is_deterministic_in_seed_and_step():
    cfg, params, batch = _model()
    a = TendencyMonitor(cfg, seed=7, device=CPU).observe(5, params, batch)
    b = TendencyMonitor(cfg, seed=7, device=CPU).observe(5, params, batch)
    assert a == b
    c = TendencyMonitor(cfg, seed=8, device=CPU).observe(5, params, batch)
    assert a != c
    d = TendencyMonitor(cfg, seed=7, device=CPU).observe(6, params, batch)
    assert a != d


def test_probe_seed_separates_seed_step_and_index():
    seeds = {tprobes.probe_seed(s, t, i)
             for s in range(3) for t in range(3) for i in range(3)}
    assert len(seeds) == 27
    assert tprobes.probe_seed(1, 2, 3) == tprobes.probe_seed(1, 2, 3)


@pytest.mark.parametrize("name", ["gemma-2b", "phi3.5-moe-42b-a6.6b"])
def test_run_probes_selects_the_references_arrays(name):
    """The arrays the program summarizes — the embedding table, the final
    layer's taps, the router logits, the embedding's gradient and a
    deeper gradient leaf — are the reference program's within 2e-5 of
    scale, and each trace is ``_trace_parts`` of its array with the
    generator of (seed, step, probe index)."""
    cfg = jconfigs.smoke_config(name)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = configs.smoke_config(name)
    tp = M.params_from_numpy(jax.device_get(jp), device=CPU)
    want_b = jtokens.make_batch(cfg, jbase.ShapeConfig("t", 16, 2, "train"))
    got_b = {k: np.asarray(v) for k, v in want_b.items()}
    specs = default_probes(tcfg, sample=24) + (
        ProbeSpec("grad_wo", "grad", target="layers/wo", sample=24),)
    jspecs = jprobes.default_probes(cfg, sample=24) + (
        jprobes.ProbeSpec("grad_wo", "grad", target="layers/wo",
                          sample=24),)
    _, _, jtaps = JM.forward(jp, cfg, {k: jnp.asarray(v)
                                       for k, v in want_b.items()},
                             taps=True)
    jgrads = jax.grad(lambda p: JS.loss_fn(p, cfg, want_b)[0])(jp)
    taps = tprobes.probe_taps(tcfg, tp, got_b)
    grads = tprobes.probe_grads(tcfg, tp, got_b, ("embed", "layers/wo"))
    assert sorted(grads) == ["embed", "layers"]
    assert list(grads["layers"]) == ["wo"]
    traces = run_probes(tcfg, specs, tp, got_b, seed=3, step=4)
    assert list(traces) == [s.name for s in specs]
    for i, (spec, jspec) in enumerate(zip(specs, jspecs)):
        got = tprobes._select(spec, tp, taps, grads)
        want = np.asarray(jprobes._select(jspec, jp, jtaps, jgrads))
        assert tuple(got.shape) == want.shape, spec.name
        scale = float(np.max(np.abs(want))) or 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * scale, err_msg=spec.name)
        gen = torch.Generator().manual_seed(tprobes.probe_seed(3, 4, i))
        h, score, k_est, _, _ = _trace_parts(got, gen, sample=24,
                                             thumbnail=0)
        tr = traces[spec.name]
        assert tr.spec == spec and tr.thumbnail is None
        assert torch.equal(tr.hopkins, h) and torch.equal(tr.k_est, k_est)
        assert torch.equal(tr.block_score, score)
        assert 0 <= float(h) <= 1 and 0 <= float(score) <= 1
    for p in M.params_from_numpy(jax.device_get(jp), device=CPU).values():
        if isinstance(p, torch.Tensor):
            assert not p.requires_grad


def test_run_probes_refuses_grad_probes_without_labels():
    cfg, params, batch = _model()
    batch.pop("labels")
    with pytest.raises(ValueError, match="labels"):
        run_probes(cfg, default_probes(cfg, sample=16), params, batch)
    with pytest.raises(ValueError, match="moe-family"):
        run_probes(cfg, (ProbeSpec("r", "router", sample=16),), params,
                   batch)

"""The port's sharded engines on ``torch.distributed``, held on the CPU
against the JAX package and against the port's own solo engines.

In-process tests run in a gloo group of one rank (a ``file://`` store under
the test's temporary directory, no TCP port), torn down after the module.
Worlds of several ranks run in a subprocess that spawns gloo ranks with
``torch.multiprocessing.spawn`` (this file run as a script), each with a
time limit, so a hung collective fails its test.

Tolerances: orders and the port's sharded-vs-solo edges are compared
exactly.  Against the reference, integer-coordinate data (every entry
exact in f32, ties included) must give the same orders bit for bit and the
same sqrt-free values; float data is held by spanning-tree weight
(``EXCESS_F32`` = 1e-5, the reference's), and rows within the pairwise
tolerance of ``test_torch_flashvat.py``, since the two frameworks round the
cross term in different places (ROADMAP §3).
"""
import datetime
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro.kernels import prim_stream as jps
from repro.kernels import ref as jref
from repro_torch import FastVAT, core
from repro_torch.api import registry
from repro_torch.api.result import ResultMeta
from repro_torch.kernels import ops, ref

F32_EPS = float(np.finfo(np.float32).eps)
EXCESS_F32 = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tolerance(metric, form, X, want):
    if metric == "euclidean" and form == "gram":
        sq = float(np.max(np.sum(np.float64(X) ** 2, axis=1)))
        return (16 * F32_EPS * sq) ** 0.5
    return 1e-5 * float(np.max(np.abs(want[np.isfinite(want)]))) + 1e-6


def _points(n, d=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _int_blobs(n, d=6, k=4, seed=0):
    """Clusters on integer coordinates: every product, norm and squared
    distance is an exact f32 integer in both frameworks, ties included."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, size=(k, d))
    return (centers[np.arange(n) % k]
            + rng.integers(-3, 4, size=(n, d))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tree_weight(X, order, metric="euclidean"):
    """Weight of the Prim tree an order implies, in f64 (direct form)."""
    Y = np.float64(X[np.asarray(order)])
    if metric == "manhattan":
        D = np.sum(np.abs(Y[:, None] - Y[None]), axis=-1)
    elif metric == "cosine":
        nrm = np.linalg.norm(Y, axis=1)
        D = np.clip(1 - (Y @ Y.T) / np.maximum(np.outer(nrm, nrm), 1e-12),
                    0, 2)
    else:
        D = np.sum((Y[:, None] - Y[None]) ** 2, axis=-1)
        if metric == "euclidean":
            D = np.sqrt(D)
    earlier = np.tri(len(Y), k=-1, dtype=bool)
    return float(np.sum(np.min(np.where(earlier, D, np.inf)[1:], axis=1)))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank for the module; destroyed after."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


# ------------------------------------------------------------ the oracle ----

def _frontier_case(n, d, seed, integer):
    """Points and an in-band frontier mixing +inf, ``UNSEEN`` and finite
    lanes, with ties planted: the pivot is lane 3 (closed), lanes 10 and 11
    are the same point one unit from it with equal (``UNSEEN``) frontier
    values, and the finite frontier values are small integers, so the
    minimum is tied."""
    rng = np.random.default_rng(seed)
    X = (rng.integers(-6, 7, size=(n, d)) if integer
         else rng.normal(size=(n, d))).astype(np.float32)
    X[10] = X[11] = X[3] + np.eye(d, dtype=np.float32)[0]
    xq = X[3].copy()
    mind = np.where(rng.random(n) < 0.3, np.inf,
                    np.where(rng.random(n) < 0.3, ref.UNSEEN,
                             rng.integers(1, 40, size=n))).astype(np.float32)
    mind[10] = mind[11] = ref.UNSEEN
    mind[3] = np.inf
    return X, xq, mind


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("form", ["gram", "direct"])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_frontier_step_ref_matches_reference(metric, form, integer):
    """``ref.prim_frontier_step_ref`` against the reference's oracle and its
    Pallas kernel in interpret mode (padded once by ``pad_points`` and
    re-masked, as ``repro.kernels.ops.prim_frontier_step`` does): +inf
    lanes stay +inf exactly; integer data bit for bit (the value) and
    to the index; float data within the pairwise tolerance."""
    n, d = 201, 5
    X, xq, mind = _frontier_case(n, d, seed=7, integer=integer)
    aux = ref.metric_aux_ref(_t(X), metric=metric)
    got, gv, gi = ref.prim_frontier_step_ref(
        _t(X), aux, _t(xq), aux[3], _t(mind), metric=metric, form=form)
    Xj = jnp.asarray(X)
    jaux = jref.metric_aux_ref(Xj, metric=metric)
    want, wv, wi = jref.prim_frontier_step_ref(
        Xj, jaux, jnp.asarray(xq), jaux[3], jnp.asarray(mind),
        metric=metric, form=form)
    Xp, auxp, n_pad, bn = jps.pad_points(Xj, jaux, block=64)
    mp = jnp.pad(jnp.asarray(mind), (0, n_pad - n), constant_values=jnp.inf)
    sel = jnp.isinf(mp)
    pm, pv, pi = jps.prim_frontier_step_pallas(
        Xp, auxp, jnp.pad(jnp.asarray(xq), (0, Xp.shape[1] - d)), auxp[3],
        mp, sel, metric=metric, form=form, block=bn, interpret=True)
    pallas = np.asarray(jnp.where(sel, jnp.inf, pm))[:n]
    got = got.numpy()
    inf = np.isinf(mind)
    exact = integer and metric in ("sqeuclidean", "manhattan")
    for other, v, i in ((np.asarray(want), wv, wi), (pallas, pv, pi)):
        assert np.array_equal(np.isinf(got), np.isinf(other))
        assert np.all(np.isinf(got[inf]))              # +inf lanes kept
        if exact:    # integer entries without sqrt or division: bitwise
            np.testing.assert_array_equal(got, other)
            assert float(gv) == float(v)
        else:        # within the pairwise tolerance
            fin = ~np.isinf(got)
            tol = _tolerance(metric, form, X, other)
            assert np.max(np.abs(got[fin] - other[fin])) <= tol
            assert abs(float(gv) - float(v)) <= tol
        if integer:  # exact ties break to the same first index
            assert int(gi) == int(i)
    # the first index among equal minima, in band
    assert int(gi) == int(np.argmin(got)) and float(gv) == got.min()


def test_frontier_round_closes_records_and_offers():
    """The plain version of the kernel (the engine's step): the least-key
    slot is the pivot, recorded as order[t] / edges[t]; its lane is closed
    on the rank that holds it; the new slot carries the global id, the
    value, the aux entry and the point of the local minimum."""
    X = _t(_int_blobs(40, d=5))
    aux = ref.metric_aux_ref(X)
    width = ref.slot_width(5)
    assert width == 12
    z = torch.tensor(0.0)
    offset = 100
    slots = [ref.make_slot(torch.tensor(v), torch.tensor(g), torch.tensor(e),
                           aux[g - offset] if 0 <= g - offset < 40 else z,
                           X[(g - offset) % 40], width)
             for v, g, e in ((3.0, 7, 9.0), (2.0, 107, 4.5), (2.0, 130, 1.0))]
    table = torch.stack(slots)
    assert int(torch.argmin(ref.slot_keys(table))) == 1
    mind = torch.full((40,), ref.UNSEEN)
    mind[30:] = torch.inf
    order = torch.zeros(5, dtype=torch.int64)
    edges = torch.zeros(5)
    new, slot = ref.prim_frontier_round_ref(X, aux, table, mind, order, edges,
                                            2, offset=offset)
    assert int(order[2]) == 107 and float(edges[2]) == 4.5
    assert torch.isinf(new[7]) and torch.all(torch.isinf(new[30:]))
    want, v, i = ref.prim_frontier_step_ref(
        X, aux, X[7], aux[7], torch.where(torch.arange(40) == 7, torch.inf,
                                          mind))
    assert torch.equal(new, want)
    assert int(ref.slot_id(slot)) == int(i) + offset
    assert float(slot[2]) == float(v) and float(slot[3]) == float(aux[i])
    assert torch.equal(slot[4:9], X[i]) and torch.all(slot[9:] == 0)


def test_engines_need_a_process_group():
    """No group, no fallback: each engine and the dvat rung raise.  (This
    runs before the module's one-rank group is set up.)"""
    assert not dist.is_initialized()
    X = _t(_points(16))
    for call in (lambda: core.vat_matrix_free_sharded(X),
                 lambda: core.dvat(X),
                 lambda: core.pairwise_dist_sharded(X),
                 lambda: FastVAT(method="dvat", device="cpu").fit(
                     _points(16))):
        with pytest.raises(RuntimeError, match="process group"):
            call()


# --------------------------------------------------- one rank, in process ----

@pytest.mark.parametrize("n", [64, 257])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_sharded_one_rank_equals_solo(world1, metric, n):
    """Sharded on one rank == the port's solo engines, order and edges bit
    for bit (the reference's own cases, tests/test_turbo.py:100-113)."""
    X = _t(_points(n, d=4, seed=n + 2))
    solo = core.vat_matrix_free(X, metric=metric)
    sh = core.vat_matrix_free_sharded(X, metric=metric)
    assert torch.equal(sh.order, solo.order)
    assert torch.equal(sh.edges, solo.edges)


def test_sharded_seed_never_forms_a_strip(world1, monkeypatch):
    """The seed scan streams blocks shorter than the shard and than n,
    never an (n/P, n) strip; the counterpart of tests/test_turbo.py:130-150
    with its guard on ``kernels.ops.pairwise_dist``."""
    real = ops.pairwise_dist
    n = 2_111
    seen = []

    def guarded(A, B=None, **kw):
        assert B is not None and A.shape[0] < n and B.shape[0] < n, \
            (A.shape, None if B is None else B.shape)
        seen.append((A.shape[0], B.shape[0]))
        return real(A, B, **kw)

    monkeypatch.setattr(ops, "pairwise_dist", guarded)
    X = _t(_points(n, d=3, seed=17))
    sh = core.vat_matrix_free_sharded(X)
    monkeypatch.setattr(ops, "pairwise_dist", real)
    assert seen and max(max(s) for s in seen) <= 1_056
    assert torch.equal(sh.order, core.vat_matrix_free(X).order)


@pytest.mark.parametrize("metric", ref.METRICS)
def test_sharded_matches_reference_on_integer_blobs(world1, metric):
    """Against ``repro.core.vat_matrix_free_sharded`` on a one-device mesh:
    the same order bit for bit on integer-coordinate blobs (exact entries,
    ties included); edges equal where no sqrt or division rounds
    (sqeuclidean, manhattan), else within the pairwise tolerance."""
    X = _int_blobs(300, d=6, seed=3)
    got = core.vat_matrix_free_sharded(_t(X), metric=metric)
    mesh = jax.make_mesh((1,), ("data",))
    want = jcore.vat_matrix_free_sharded(jnp.asarray(X), mesh, metric=metric)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    edges = np.asarray(want.edges)
    if metric in ("sqeuclidean", "manhattan"):
        np.testing.assert_array_equal(got.edges.numpy(), edges)
    else:
        assert np.max(np.abs(got.edges.numpy() - edges)) <= _tolerance(
            metric, "gram", X, edges)


@pytest.mark.parametrize("metric", ref.METRICS)
def test_sharded_matches_reference_by_tree_weight(world1, metric):
    """Float data: the two frameworks' rows round apart, so near-ties may
    flip; the orders are held by spanning-tree weight (EXCESS_F32)."""
    X = _points(400, d=5, seed=21)
    got = core.vat_matrix_free_sharded(_t(X), metric=metric)
    mesh = jax.make_mesh((1,), ("data",))
    want = jcore.vat_matrix_free_sharded(jnp.asarray(X), mesh, metric=metric)
    assert sorted(got.order.tolist()) == list(range(400))
    w_got = _tree_weight(X, got.order.numpy(), metric)
    w_want = _tree_weight(X, np.asarray(want.order), metric)
    assert abs(w_got - w_want) <= EXCESS_F32 * w_want


def test_pairwise_dist_sharded_matches(world1):
    """One rank holds every row; the cross-operand call keeps the computed
    diagonal, as the reference's does (tests/test_core_extra.py:98-104)."""
    X = _points(64, d=4)
    got = core.pairwise_dist_sharded(_t(X)).numpy()
    mesh = jax.make_mesh((1,), ("data",))
    want = np.asarray(jcore.pairwise_dist_sharded(jnp.asarray(X), mesh))
    assert got.shape == (64, 64)
    assert np.max(np.abs(got - want)) <= _tolerance("euclidean", "gram", X,
                                                    want)
    np.testing.assert_allclose(got, ops.pairwise_dist(_t(X)).numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("exact_start", [True, False])
def test_dvat_one_rank_matches_vat_and_reference(world1, exact_start):
    """dvat on one rank: the exact start gives ``vat``'s order (the
    reference's tests/test_core_extra.py:91-96 case), and either start the
    reference dvat's order on integer blobs."""
    X = _points(64, d=4)
    got = core.dvat(_t(X), exact_start=exact_start).order
    if exact_start:
        np.testing.assert_array_equal(got.numpy(),
                                      core.vat(_t(X)).order.numpy())
    assert sorted(got.tolist()) == list(range(64))
    Xi = _int_blobs(96, d=5, seed=4)
    mesh = jax.make_mesh((1,), ("data",))
    want = jcore.dvat(jnp.asarray(Xi), mesh, exact_start=exact_start)
    np.testing.assert_array_equal(
        core.dvat(_t(Xi), exact_start=exact_start).order.numpy(),
        np.asarray(want.order))


# --------------------------------------------------------------- registry ----

def test_dvat_rung_needs_more_than_one_rank(world1, monkeypatch):
    """As the reference without devices: RuntimeError at one rank; and
    ValueError when the world size does not divide n."""
    with pytest.raises(RuntimeError, match="more than one rank"):
        FastVAT(method="dvat", device="cpu").fit(_points(64))
    monkeypatch.setattr(registry, "_world_size", lambda: 3)
    with pytest.raises(ValueError, match="divisible"):
        FastVAT(method="dvat", device="cpu").fit(_points(64))


def test_svat_and_dvat_are_registered():
    assert "svat" not in registry.UNPORTED and "dvat" not in registry.UNPORTED
    assert {"svat", "dvat"} <= set(registry.registered())
    assert registry.get_rung("dvat").check is not None
    assert registry.get_rung("svat").auto_threshold is None
    assert registry.FLASH_SHARD_MIN_N == 4_096


@pytest.mark.parametrize("world,n,turbo,form,sharded", [
    (2, 4_096, None, "gram", True),
    (2, 4_095, None, "gram", False),
    (1, 4_096, None, "gram", False),
    (2, 4_096, True, "gram", False),
    (2, 4_096, False, "gram", False),
    (2, 4_096, None, "direct", False),
])
def test_flash_order_auto_shard_rule(monkeypatch, world, n, turbo, form,
                                     sharded):
    """The reference's rule (repro/api/registry.py:412-436): turbo None,
    more than one rank, n >= FLASH_SHARD_MIN_N and the gram form shard;
    anything else runs the solo engine."""
    calls = []
    monkeypatch.setattr(registry, "_world_size", lambda: world)
    monkeypatch.setattr(core, "vat_matrix_free_sharded",
                        lambda X, **kw: calls.append("sharded"))
    monkeypatch.setattr(core, "vat_matrix_free",
                        lambda X, **kw: calls.append(("solo", kw["turbo"])))
    meta = ResultMeta(method="flashvat", n=n, device="cpu")
    registry._flash_order(_t(_points(8)), meta, registry.RungOptions(
        turbo=turbo, num_form=form))
    assert calls == (["sharded"] if sharded
                     else [("solo", turbo is not False)])


# ------------------------------------------------- several ranks, spawned ----

def _two_blobs():
    """The reference's two-blob input (tests/test_api_result.py:58-74)."""
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(size=(32, 4)),
                           rng.normal(size=(32, 4)) + 8]).astype(np.float32)


def _check_sharded_world(group, sizes):
    rng = np.random.default_rng(1)
    for metric in ref.METRICS:
        for n in sizes:
            X = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
            solo = core.vat_matrix_free(X, metric=metric)
            sh = core.vat_matrix_free_sharded(X, group, metric=metric)
            assert torch.equal(sh.order, solo.order), (metric, n)
            assert torch.equal(sh.edges, solo.edges), (metric, n)


def _world_main(rank, world, case, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        if case == "four":
            _check_sharded_world(None, (64, 100))     # 100 % 4: padding
            three = dist.new_group([0, 1, 2])
            if rank < 3:
                _check_sharded_world(three, (257,))
            X = torch.from_numpy(_points(64, d=4, seed=1))
            assert torch.equal(core.dvat(X).order, core.vat(X).order)
            d2 = core.dvat(X, exact_start=False).order
            assert sorted(d2.tolist()) == list(range(64))
            fv = FastVAT(method="dvat", sample_size=16,
                         device="cpu").fit(_two_blobs())
            assert sorted(fv.order().tolist()) == list(range(64))
            assert fv.image().shape == (16, 16)
            rep = fv.assess()
            assert rep["method"] == "dvat" and rep["k_est"] == 2, dict(rep)
        elif case == "auto":
            calls = []
            real = ops.prim_frontier_step

            def counted(*args, **kw):
                calls.append(1)
                return real(*args, **kw)

            ops.prim_frontier_step = counted
            rng = np.random.default_rng(5)
            X = np.concatenate([rng.normal(size=(2_048, 8)) + c
                                for c in (0.0, 6.0)]).astype(np.float32)
            fv = FastVAT(device="cpu").fit(X)
            assert fv.method_resolved == "flashvat"
            assert fv.result.meta.numerics.form == "gram"
            assert len(calls) == 4_096, len(calls)
            solo = core.vat_matrix_free(fv._X.float(), turbo=True)
            assert np.array_equal(fv.order(), solo.order.numpy())
        dist.barrier()
        if rank == 0:
            print(f"WORLD_OK {case}", flush=True)
    finally:
        dist.destroy_process_group()


def _spawn_world(case, world, tmp_path, timeout):
    """Run this file as a script that spawns ``world`` gloo ranks; kill its
    whole process group if it outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(world),
         str(tmp_path / f"store-{case}")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"world {case} outlived {timeout} s: {err[-2000:]}")
    assert f"WORLD_OK {case}" in out, err[-3000:]


def test_sharded_worlds_of_four_and_three(tmp_path):
    """P = 4 at n in {64, 100} (100 % 4 pads) and P = 3 at n = 257, four
    metrics: every rank's order and edges == the port's solo engine, bit
    for bit (tests/test_turbo.py:385-418); dvat at P = 4 == vat's order;
    ``FastVAT(method="dvat")`` reads k_est == 2 on the two-blob input."""
    _spawn_world("four", 4, tmp_path, timeout=240)


def test_auto_fit_shards_over_two_ranks(tmp_path):
    """``FastVAT(device="cpu").fit(X)`` at n = 4,096 under two ranks takes
    the sharded engine (n frontier steps a rank) and gives the solo
    order."""
    _spawn_world("auto", 2, tmp_path, timeout=240)


if __name__ == "__main__":
    import torch.multiprocessing as mp
    _case, _world, _store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_world_main, args=(_world, _case, _store), nprocs=_world)

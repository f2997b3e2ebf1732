"""The stepwise engine's recording step, held on the CPU: its plain version
(``ref.prim_stream_record_ref``, which writes ``order[t]``, ``edges[t]``
and ``selected`` itself) against the loop of single steps it replaced and
against the JAX package's stepwise engine; and the sharded engine, whose
step is built once a traversal too, against the solo engines at gloo
worlds of one to four ranks.

Tolerances: against the loop of single steps, everything bit for bit (the
same plain code).  Against the reference, integer-coordinate data (every
product, norm and squared distance an exact f32 integer in both
frameworks, ties included) gives the same orders and edges bit for bit;
float data is held by spanning-tree weight (``EXCESS_F32`` = 1e-5, the
reference's), since the two frameworks round the cross term in different
places.  Worlds of several ranks run in a subprocess that spawns gloo ranks
(this file run as a script) under a time limit.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from repro import core as jcore
from repro_torch import core
from repro_torch.core.vat import _streamed_seed_pivot
from repro_torch.kernels import ops, ref

EXCESS_F32 = 1e-5
FORMS = ("gram", "direct")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _points(n, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _int_blobs(n, d=6, k=4, seed=0):
    """Clusters on integer coordinates: exact f32 arithmetic in both
    frameworks."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, size=(k, d))
    return (centers[np.arange(n) % k]
            + rng.integers(-3, 4, size=(n, d))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _loop_of_single_steps(X, aux, i0, *, metric, form):
    """The stepwise traversal as the engine ran it before its step recorded
    itself: one ``ops.prim_stream_step`` a vertex, then the record and the
    mask kept by three torch ops.  Returns (order, edges, mind, sel)."""
    n = X.shape[0]
    q = i0.view(1)
    mind = torch.full((n,), torch.inf)
    sel = torch.zeros(n, dtype=torch.bool)
    sel.index_fill_(0, q, True)
    order = torch.zeros(n, dtype=torch.int64)
    order[0:1] = q
    edges = torch.zeros(n)
    for t in range(1, n):
        mind, ev, nq = ops.prim_stream_step(X, aux, q, mind, sel,
                                            metric=metric, form=form)
        q = nq.view(1)
        sel.index_fill_(0, q, True)
        order[t:t + 1] = q
        edges[t:t + 1] = ev.view(1)
    return order, edges, mind, sel


def _tree_weight(X, order, metric):
    """f64 spanning-tree weight of a Prim order: each vertex's least
    dissimilarity to the vertices before it."""
    Y = np.float64(X[np.asarray(order)])
    if metric == "manhattan":
        D = np.sum(np.abs(Y[:, None, :] - Y[None, :, :]), axis=-1)
    elif metric == "cosine":
        nrm = np.sqrt(np.sum(Y * Y, axis=1))
        D = np.clip(1.0 - (Y @ Y.T) / np.maximum(np.outer(nrm, nrm), 1e-12),
                    0.0, 2.0)
    else:
        sq = np.sum(Y * Y, axis=1)
        D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * Y @ Y.T, 0.0)
        if metric == "euclidean":
            D = np.sqrt(D)
    earlier = np.tri(len(Y), k=-1, dtype=bool)
    return float(np.sum(np.min(np.where(earlier, D, np.inf)[1:], axis=1)))


# ------------------------------------------- the plain recording step ----

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_record_step_state_equals_the_single_step(metric, form):
    """Step by step at n = 60: the recording step leaves the frontier, the
    mask and the record exactly where a single step and the three torch ops
    leave them."""
    X = _t(_points(60, seed=1))
    aux = ops.metric_aux(X, metric=metric)
    i0 = _streamed_seed_pivot(X, metric=metric, form=form)
    mind = torch.full((60,), torch.inf)
    sel = torch.zeros(60, dtype=torch.bool)
    sel[i0] = True
    order = torch.zeros(60, dtype=torch.int64)
    order[0] = i0
    edges = torch.zeros(60)
    rec = [t.clone() for t in (mind, sel, order, edges)]
    step = ops.prim_stream_stepper(X, aux, *rec, metric=metric, form=form)
    for t in range(1, 60):
        mind, ev, nq = ops.prim_stream_step(X, aux, order[t - 1:t], mind, sel,
                                            metric=metric, form=form)
        sel[nq] = True
        order[t] = nq
        edges[t] = ev
        step(t)
        for got, want in zip(rec, (mind, sel, order, edges)):
            assert torch.equal(got, want), t


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [1, 2, 37, 300])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_recording_engine_equals_the_loop(metric, n, form):
    """``core.vat_matrix_free(turbo=False)``, whose loop is the recording
    step and nothing else, gives the loop of single steps' order and edges
    bit for bit, and the persistent engine's."""
    X = _t(_points(n, seed=n))
    aux = ops.metric_aux(X, metric=metric)
    i0 = _streamed_seed_pivot(X, metric=metric, form=form)
    want_o, want_e, _, sel = _loop_of_single_steps(X, aux, i0, metric=metric,
                                                   form=form)
    got = core.vat_matrix_free(X, metric=metric, form=form, turbo=False)
    assert torch.equal(got.order, want_o) and torch.equal(got.edges, want_e)
    assert bool(sel.all())
    turbo = core.vat_matrix_free(X, metric=metric, form=form)
    assert torch.equal(got.order, turbo.order)
    assert torch.equal(got.edges, turbo.edges)


@pytest.mark.parametrize("metric", ref.METRICS)
def test_batched_record_lanes_equal_solo(metric):
    """The plain recording step on a (b, n, d) stack: each lane's order and
    edges are its solo engine's bit for bit."""
    Xs = _t(np.stack([_points(80, seed=s) for s in range(3)]))
    got = core.vat_matrix_free_batch(Xs, metric=metric, turbo=False)
    assert got.order.shape == got.edges.shape == (3, 80)
    for z in range(3):
        solo = core.vat_matrix_free(Xs[z], metric=metric, turbo=False)
        assert torch.equal(got.order[z], solo.order)
        assert torch.equal(got.edges[z], solo.edges)


def test_cpu_stepper_launches_no_kernel():
    """On the CPU the stepper is the plain version: no kernel launch."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    core.vat_matrix_free(_t(_points(40)), turbo=False)
    assert _build.launch_counts() == dict.fromkeys(_build.LAUNCHES, 0)


# ------------------------------------------------- against the reference ----

@pytest.mark.parametrize("metric", ref.METRICS)
def test_recording_engine_equals_reference_on_integer_data(metric):
    """On integer coordinates the port's recording engine and the JAX
    package's stepwise engine (``turbo=False``, its XLA step on the CPU)
    give the same order and edges bit for bit."""
    X = _int_blobs(240, seed=3)
    got = core.vat_matrix_free(_t(X), metric=metric, turbo=False)
    want = jcore.vat_matrix_free(jnp.asarray(X), metric=metric, turbo=False)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))


@pytest.mark.parametrize("metric", ref.METRICS)
def test_recording_engine_float_data_within_tree_weight(metric):
    """On float data the two stepwise engines' orders span trees of the
    same weight within EXCESS_F32."""
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(size=(150, 6)) + c
                        for c in (0.0, 7.0, -7.0)]).astype(np.float32)
    got = core.vat_matrix_free(_t(X), metric=metric, turbo=False)
    want = jcore.vat_matrix_free(jnp.asarray(X), metric=metric, turbo=False)
    assert sorted(got.order.tolist()) == list(range(len(X)))
    w_got = _tree_weight(X, got.order.numpy(), metric)
    w_want = _tree_weight(X, np.asarray(want.order), metric)
    assert abs(w_got - w_want) / w_want <= EXCESS_F32


# ------------------------------------------------ the sharded engine ----

def _world_main(rank, world, store):
    """One gloo rank: the sharded engine, whose frontier step is built once
    a traversal, == the solo recording engine and the persistent engine on
    every rank, order and edges bit for bit."""
    import datetime
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for metric in ref.METRICS:
            for n in (1, 37, 130):
                X = _t(_points(n, d=4, seed=n))
                sh = core.vat_matrix_free_sharded(X, metric=metric)
                for turbo in (False, True):
                    solo = core.vat_matrix_free(X, metric=metric,
                                                turbo=turbo)
                    assert torch.equal(sh.order, solo.order), (metric, n)
                    assert torch.equal(sh.edges, solo.edges), (metric, n)
        dist.barrier()
        if rank == 0:
            print(f"WORLD_OK {world}", flush=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sharded_equals_solo_over_gloo_worlds(world, tmp_path):
    """Worlds of one to four ranks (n = 1 and 37 leave ranks with padding
    only; 130 is ragged at every world size)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(world),
         str(tmp_path / "store")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"world of {world} outlived 240 s: {err[-2000:]}")
    assert f"WORLD_OK {world}" in out, err[-3000:]


if __name__ == "__main__":
    import torch.multiprocessing as mp
    _world, _store = int(sys.argv[1]), sys.argv[2]
    mp.spawn(_world_main, args=(_world, _store), nprocs=_world)

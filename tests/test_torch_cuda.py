"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips when
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor
``repro``, so it runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

The sharded engine's tests run it in an NCCL group of one rank in this
process, and over every visible card in a spawned world (this file run as a
script), which needs two cards or more.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import core
from repro_torch.core.vat import _streamed_seed_pivot, vat, vat_order
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ivat_update import (ivat_from_vat_cuda,
                                            ivat_parents_cuda,
                                            ivat_range_cuda, ivat_route_cuda,
                                            ivat_serial_cuda,
                                            reset_route_lanes, route_lanes)
from repro_torch.kernels.knn_graph import (MAX_K, knn_graph_batch_cuda,
                                          knn_topk_blocked, knn_topk_cuda,
                                          knn_topk_segmented_cuda)
from repro_torch.kernels.pairwise_dist import (metric_aux_cuda,
                                              pairwise_dist_batch_cuda,
                                              pairwise_dist_cuda)
from repro_torch.kernels.prim_persist import prim_persist_cuda
from repro_torch.kernels.prim_stream import (FrontierStep, StreamRecord,
                                            prim_frontier_step_cuda,
                                            prim_stream_step_batch_cuda,
                                            prim_stream_step_cuda)
from repro_torch.kernels.prim_update import (masked_argmin_cuda,
                                             vat_prim_order_cuda)

F32_EPS = float(np.finfo(np.float32).eps)
FORMS = ("gram", "direct")


def _tolerance(metric, form, X, Y, want):
    """A sqrt of the Gram cancellation floor for gram-form euclidean,
    1e-5 of the matrix scale (+1e-6) otherwise."""
    if metric == "euclidean" and form == "gram":
        sq = max(float(torch.amax(torch.sum(A.double() ** 2, dim=1)))
                 for A in (X, X if Y is None else Y))
        return (16 * F32_EPS * sq) ** 0.5
    return 1e-5 * float(torch.amax(torch.abs(want))) + 1e-6


def _argmin_cases(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-5, 6, size=n).astype(np.float32)   # many ties
    all_but_one = np.ones(n, bool)
    all_but_one[n // 3] = False
    return vals, {"random": rng.random(n) < 0.5, "none": np.zeros(n, bool),
                  "all_but_one": all_but_one, "all": np.ones(n, bool)}


def _vat_ordered(n, seed, device, d=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, d, generator=gen, device=device)
    X[n // 2:] += 5.0
    return vat(X).rstar


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


#: (n, m, d, offset) of the pairwise kernel's cases: m None is the
#: self-matrix (one triangle of tiles, mirrored); offset > 0 starts X that
#: many floats into its buffer, a base that is not 16-byte aligned.  Self n
#: around one and two tiles of 128 (a diagonal tile, ragged off-diagonal
#: tiles), d across the staging depths (8, 16, 32) and both copy widths.
PAIRWISE_CASES = ([(301, None, 7, 0), (200, 129, 70, 0)]
                  + [(n, None, d, 0) for n in (127, 128, 129, 255, 257)
                     for d in (1, 3, 8, 33, 64)]
                  + [(129, None, 64, 1), (2000, 713, 64, 0),
                     (1, 300, 3, 0), (2000, 713, 16, 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,d,offset", PAIRWISE_CASES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_pairwise_against_plain(cuda, metric, form, n, m, d, offset,
                                     dtype):
    """Within the pairwise tolerance of the plain version; a self-matrix is
    exactly symmetric, and ops.pairwise_dist's (the kernel's zero diagonal)
    equals it off the diagonal bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(n * 100 + d)
    buf = torch.randn(offset + n * d, device=cuda, generator=gen)
    X = buf[offset:].view(n, d).to(getattr(torch, dtype))
    Y = None if m is None else torch.randn(
        m, d, device=cuda, generator=gen).to(X.dtype)
    got = pairwise_dist_cuda(X, Y, metric=metric, form=form)
    want = ref.pairwise_dissim_ref(X, Y, metric=metric, form=form)
    tol = _tolerance(metric, form, X.float(), None if Y is None
                     else Y.float(), want)
    assert float(torch.amax(torch.abs(got - want))) <= tol
    if Y is None:
        assert torch.equal(got, got.T)
        R = ops.pairwise_dist(X, metric=metric, form=form)
        assert not bool(torch.diagonal(R).any())
        off = ~torch.eye(n, dtype=torch.bool, device=cuda)
        assert torch.equal(R[off], got[off])


@pytest.mark.cuda
def test_cuda_masked_argmin_bitwise(cuda):
    for n in (17, 4096, 4097, 20000):
        vals, masks = _argmin_cases(n, seed=n)
        v = torch.from_numpy(vals).to(cuda)
        for mask in masks.values():
            mk = torch.from_numpy(mask).to(cuda)
            kv, ki = masked_argmin_cuda(v, mk)
            pv, pi = ref.masked_argmin_ref(v, mk)
            assert int(ki) == int(pi)
            assert np.float32(kv.cpu()).tobytes() == \
                np.float32(pv.cpu()).tobytes()


@pytest.mark.cuda
def test_cuda_ivat_bitwise(cuda):
    for n in (1, 2, 65, 700):
        rstar = (_vat_ordered(n, n, cuda) if n > 1
                 else torch.zeros(1, 1, device=cuda))
        torch.testing.assert_close(ivat_from_vat_cuda(rstar),
                                   ref.ivat_from_vat_ref(rstar),
                                   rtol=0, atol=0)
    stack = torch.stack([_vat_ordered(90, s, cuda) for s in range(3)])
    batch = ivat_from_vat_cuda(stack)
    for lane in range(3):
        assert torch.equal(batch[lane], ivat_from_vat_cuda(stack[lane]))


def _swapped_non_prim(rstar):
    """rstar with two neighbouring rows (and columns) swapped so that the
    range route's condition breaks (checked with the plain stages)."""
    n = rstar.shape[0]
    for p in range(1, n - 1):
        perm = torch.arange(n, device=rstar.device)
        perm[[p, p + 1]] = perm[[p + 1, p]]
        R2 = rstar[perm][:, perm].contiguous()
        if not bool(ref.ivat_route_ref(*ref.ivat_parents_ref(R2))):
            return R2
    raise AssertionError("no swap breaks the condition")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 700, 4097])
def test_cuda_ivat_range_route_equals_recurrence(cuda, n):
    rstar = (_vat_ordered(n, n, cuda) if n > 1
             else torch.zeros(1, 1, device=cuda))
    reset_route_lanes()
    got = ivat_from_vat_cuda(rstar)
    assert route_lanes() == {"range": 1, "serial": 0}
    assert torch.equal(got, ref.ivat_from_vat_ref(rstar))
    assert not bool(torch.signbit(got).any())
    # each stage against its plain version
    j, w = ivat_parents_cuda(rstar[None])
    pj, pw = ref.ivat_parents_ref(rstar[None])
    assert torch.equal(j, pj)
    assert torch.equal(w.view(torch.int32), pw.view(torch.int32))
    ok, tables = ivat_route_cuda(j, w)
    assert torch.equal(ok, ref.ivat_route_ref(pj, pw))
    assert torch.equal(ivat_range_cuda(w, tables, ok), ref.ivat_range_ref(pw))
    assert torch.equal(ivat_serial_cuda(rstar), ref.ivat_from_vat_ref(rstar))
    # an empty stack keeps its shape and launches nothing
    _build.reset_launch_counts()
    reset_route_lanes()
    empty = ivat_from_vat_cuda(torch.empty(0, n, n, device=cuda))
    assert empty.shape == (0, n, n)
    assert _build.LAUNCHES["ivat_from_vat"] == 0
    assert route_lanes() == {"range": 0, "serial": 0}


@pytest.mark.cuda
def test_cuda_ivat_non_prim_takes_the_serial_route(cuda):
    prim = _vat_ordered(300, 5, cuda)
    R2 = _swapped_non_prim(prim)
    reset_route_lanes()
    got = ivat_from_vat_cuda(R2)
    assert route_lanes() == {"range": 0, "serial": 1}
    assert torch.equal(got, ref.ivat_from_vat_ref(R2))
    j, w = ivat_parents_cuda(prim)
    w2 = w.clone()
    w2[7] = torch.nan                   # a NaN weight fails the check too
    assert ivat_route_cuda(torch.stack([j, j]), torch.stack([w, w2]))[0] \
        .tolist() == [True, False]


@pytest.mark.cuda
def test_cuda_ivat_mixed_stack_lanes_equal_solo(cuda):
    prim = [_vat_ordered(257, s, cuda) for s in range(3)]
    stack = torch.stack([prim[0], _swapped_non_prim(prim[1]), prim[2]])
    reset_route_lanes()
    got = ivat_from_vat_cuda(stack)
    assert route_lanes() == {"range": 2, "serial": 1}
    for z in range(3):
        assert torch.equal(got[z], ivat_from_vat_cuda(stack[z]))
        assert torch.equal(got[z], ref.ivat_from_vat_ref(stack[z]))


@pytest.mark.cuda
def test_cuda_pairwise_bf16_storage(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    X = torch.randn(150, 33, device=cuda, generator=gen).bfloat16()
    for metric in ref.METRICS:
        got = pairwise_dist_cuda(X, metric=metric)
        want = ref.pairwise_dissim_ref(X, metric=metric)
        assert float(torch.amax(torch.abs(got - want))) <= _tolerance(
            metric, "gram", X.float(), None, want)


@pytest.mark.cuda
def test_cuda_fit_launches_every_kernel(cuda):
    from repro_torch import FastVAT
    from repro_torch.kernels import _build
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(100, 3)),
                        rng.normal(size=(100, 3)) + 8]).astype(np.float32)
    _build.reset_launch_counts()
    fv = FastVAT(method="ivat").fit(X)
    assert _build.launch_counts() == {"pairwise_dist": 1,
                                      "masked_argmin": 0,
                                      "ivat_from_vat": 1,
                                      "prim_persist": 0,
                                      "prim_stream_step": 0,
                                      "knn_graph": 0,
                                      "pairwise_dist_batch": 0,
                                      "prim_stream_step_batch": 0,
                                      "knn_graph_batch": 0,
                                      "prim_frontier_step": 0,
                                      "vat_prim_order": 1,
                                      "knn_graph_segmented": 0}
    assert fv.result.meta.device.startswith("cuda")
    assert fv.result.order.is_cuda and fv.result.ivat_image.is_cuda
    rep = fv.assess()
    assert rep.k_est == 2 and rep.clustered


@pytest.mark.cuda
def test_cuda_fit_on_a_device_that_is_not_current(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from repro_torch import FastVAT
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(100, 3)),
                        rng.normal(size=(100, 3)) + 8]).astype(np.float32)
    other = f"cuda:{torch.cuda.device_count() - 1}"
    assert torch.cuda.current_device() != int(other[5:])
    fv = FastVAT(device=other).fit(X)
    assert fv.result.order.device == torch.device(other)
    here = FastVAT().fit(X)
    np.testing.assert_array_equal(fv.order(), here.order())
    np.testing.assert_array_equal(fv.image(use_ivat=True),
                                  here.image(use_ivat=True))
    assert fv.assess().k_est == here.assess().k_est == 2


# ------------------------------------------------------ the Prim kernels ----

def _contig_blobs(n, d=3, k=4, seed=1, sep=40.0, offset=0.0):
    """Clusters on adjacent indices, so tiles are coherent and pruning has
    something to prune; ``offset`` moves them far from the origin."""
    rng = np.random.default_rng(seed)
    centers = sep * rng.normal(size=(k, d))
    lab = np.sort(rng.integers(0, k, size=n))
    return (centers[lab] + rng.normal(size=(n, d)) + offset).astype(
        np.float32)


def _frontier_minima(R, order):
    """edges[t] of a Prim ordering read off the matrix: the least entry of
    row order[t] over the earlier vertices."""
    Rs = R.index_select(0, order).index_select(1, order)
    n = R.shape[0]
    earlier = torch.ones(n, n, dtype=torch.bool, device=R.device).tril(-1)
    return torch.amin(torch.where(earlier, Rs, torch.inf)[1:], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_prim_stream_step_against_plain(cuda, metric, form):
    """The step kernel's frontier is the plain fold within the pairwise
    tolerance, and its pair is the plain argmin of its own frontier, bit
    for bit (several CTAs at n = 1,000)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    X = torch.randn(1000, 19, device=cuda, generator=gen)
    aux = metric_aux_cuda(X, metric=metric)
    mind = torch.rand(1000, device=cuda, generator=gen) * 4.0
    sel = torch.rand(1000, device=cuda, generator=gen) < 0.3
    q = torch.tensor(17, device=cuda)
    want, _, _ = ref.prim_stream_step_ref(X, aux, q, mind.clone(), sel,
                                          metric=metric, form=form)
    got, ev, nq = prim_stream_step_cuda(X, aux, q, mind, sel, metric=metric,
                                        form=form)
    tol = _tolerance(metric, form, X, None, want)
    assert float(torch.amax(torch.abs(got - want))) <= tol
    pv, pi = ref.masked_argmin_ref(got, sel)
    assert int(nq) == int(pi) and torch.equal(ev.view(1), pv.view(1))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 64])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_prim_stream_row_equals_pairwise_row(cuda, metric, form, d):
    """The step kernel's pivot row, folded into a frontier of +inf, is the
    pairwise kernel's row q bit for bit (off q itself, which stays
    selected)."""
    n, q = 1000, 417
    X = torch.randn(n, d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(d))
    aux = metric_aux_cuda(X, metric=metric)
    mind = torch.full((n,), torch.inf, device=cuda)
    sel = torch.zeros(n, dtype=torch.bool, device=cuda)
    sel[q] = True
    row, _, _ = prim_stream_step_cuda(X, aux, torch.tensor(q, device=cuda),
                                      mind, sel, metric=metric, form=form)
    R = ops.pairwise_dist(X, metric=metric, form=form)
    assert torch.equal(row[~sel], R[q][~sel])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 257, 1024])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_flashvat_three_way_bitwise(cuda, metric, n):
    """Persistent == stepwise == vat_order on the pairwise kernel's matrix,
    order and edges bit for bit, and the edges are that matrix's frontier
    minima."""
    X = torch.randn(n, 3 + n % 5, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(n))
    R = ops.pairwise_dist(X, metric=metric)
    want = vat_order(R)
    turbo = core.vat_matrix_free(X, metric=metric)
    stepw = core.vat_matrix_free(X, metric=metric, turbo=False)
    assert torch.equal(turbo.order, want)
    assert torch.equal(stepw.order, want)
    assert torch.equal(turbo.edges, stepw.edges)
    assert torch.equal(turbo.edges[1:], _frontier_minima(R, want))
    assert int(_streamed_seed_pivot(X, metric=metric)) == int(want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3100, 3101])
def test_cuda_flashvat_wide_rows(cuda, d):
    """Rows too wide to stage in shared memory (d > 3,070): the persistent
    kernel reads pivot rows from global memory, float4 or not, and still
    equals the stepwise engine and the materialized order."""
    X = torch.randn(300, d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(d))
    want = vat_order(ops.pairwise_dist(X))
    turbo = core.vat_matrix_free(X, block=64)
    stepw = core.vat_matrix_free(X, turbo=False)
    assert torch.equal(turbo.order, want) and torch.equal(stepw.order, want)
    assert torch.equal(turbo.edges, stepw.edges)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan"])
def test_cuda_pruning_is_bitwise_sound_and_cuts_traffic(cuda, metric):
    """prune=True vs prune=False in the same kernel: the same order and
    edges for every block length; the eager schedule folds at most
    (n - 1)·nblk tiles, the pruned one far fewer on contiguous clusters;
    both evaluate exactly n·(n - 1)/2 pairs."""
    n = 700
    X = torch.from_numpy(_contig_blobs(n)).to(cuda)
    aux = metric_aux_cuda(X, metric=metric)
    i0 = _streamed_seed_pivot(X, metric=metric)
    first = None
    for block in (64, 256, 1024):
        o1, e1, s1 = prim_persist_cuda(X, aux, i0, metric=metric, block=block)
        o0, e0, s0 = prim_persist_cuda(X, aux, i0, metric=metric, block=block,
                                       prune=False)
        assert torch.equal(o1, o0) and torch.equal(e1, e0)
        nblk = -(-n // block)
        assert int(s0[0]) <= (n - 1) * nblk
        assert int(s0[2]) == int(s1[2]) == n * (n - 1) // 2
        if block == 64:
            assert int(s1[0]) < int(s0[0]) * 2 // 3, (s1, s0)
        first = (o1, e1) if first is None else first
        assert torch.equal(o1, first[0]) and torch.equal(e1, first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [100.0, 1000.0])
@pytest.mark.parametrize("form", FORMS)
def test_cuda_pruning_sound_on_uncentered_data(cuda, form, offset):
    """Far from the origin the gram rows carry absolute error ~eps·max|x|²;
    the slack debit keeps pruned == eager in both forms."""
    X = torch.from_numpy(_contig_blobs(500, sep=5.0, offset=offset)).to(cuda)
    for metric in ("euclidean", "sqeuclidean"):
        aux = metric_aux_cuda(X, metric=metric)
        i0 = _streamed_seed_pivot(X, metric=metric, form=form)
        o1, e1, _ = prim_persist_cuda(X, aux, i0, metric=metric, form=form,
                                      block=64)
        o0, e0, _ = prim_persist_cuda(X, aux, i0, metric=metric, form=form,
                                      block=64, prune=False)
        assert torch.equal(o1, o0) and torch.equal(e1, e0)


@pytest.mark.cuda
def test_cuda_prim_persist_against_plain(cuda):
    """The kernel against ``ref.prim_persist_ref`` on the same tensors: the
    plain rows come from cuBLAS, so the orders are held by spanning-tree
    weight (EXCESS_F32 = 1e-5) and the edges by the pairwise tolerance."""
    X = torch.from_numpy(_contig_blobs(600, d=5, sep=8.0)).to(cuda)
    aux = metric_aux_cuda(X, metric="euclidean")
    i0 = _streamed_seed_pivot(X, metric="euclidean")
    order, edges, _ = prim_persist_cuda(X, aux, i0)
    porder, pedges = ref.prim_persist_ref(X, aux, i0)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(600, device=cuda))
    R = torch.cdist(X.double(), X.double())
    wk = float(torch.sum(_frontier_minima(R, order)))
    wp = float(torch.sum(_frontier_minima(R, porder)))
    assert abs(wk - wp) / wp <= 1e-5
    assert float(torch.amax(torch.abs(torch.sort(edges).values
                                      - torch.sort(pedges).values))) <= \
        _tolerance("euclidean", "gram", X, None, edges)


@pytest.mark.cuda
def test_cuda_flashvat_fit_launches_its_kernels(cuda):
    from repro_torch import FastVAT
    from repro_torch.kernels import _build
    X = _contig_blobs(3000, d=6)
    _build.reset_launch_counts()
    fv = FastVAT().fit(X)
    counts = _build.launch_counts()
    assert fv.method_resolved == "flashvat"
    assert counts["prim_persist"] == 1 and counts["prim_stream_step"] == 0
    assert counts["vat_prim_order"] == 1 and counts["masked_argmin"] == 0
    assert counts["ivat_from_vat"] == 1
    assert counts["pairwise_dist"] == 4 + 1   # 2 x 2 seed blocks + render
    step = FastVAT(method="flashvat", turbo=False).fit(X)
    np.testing.assert_array_equal(step.order(), fv.order())
    assert fv.image().shape == (256, 256)
    assert fv.sample_indices().shape == (256,)
    rep = fv.assess()
    assert rep.k_est == 4 and rep.clustered


# ------------------------------------------------------ the kNN kernel ----

def _plain_knn(Xq, Xc, qid, cid, k, metric):
    """The kNN kernel's plain version on the card: the pairwise kernel's
    block, masked, stably sorted by (value, id), first k."""
    return ref.topk_from_dissim(pairwise_dist_cuda(Xq, Xc, metric=metric),
                                qid, cid, k)


def _assert_same_lists(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_knn_kernel_bitwise_against_plain(cuda, metric):
    """Self form (the exact kNN graph) at ragged n and d, k in {1, 15, 128}
    (k = 128 > n - 1 at n = 64 leaves (+inf, -1) slots), and integer data
    full of exact ties, where the lower id must win."""
    assert _build.library().repro_knn_max_k() == MAX_K
    gen = torch.Generator(device=cuda).manual_seed(5)
    for n, d in ((64, 3), (257, 64), (1024, 100)):
        for X in (torch.randn(n, d, device=cuda, generator=gen),
                  torch.randint(-2, 3, (n, d), device=cuda,
                                generator=gen).float()):
            ids = torch.arange(n, device=cuda)
            for k in (1, 15, 128):
                got = knn_topk_cuda(X, X, ids, ids, k=k, metric=metric)
                _assert_same_lists(got, _plain_knn(X, X, ids, ids, k,
                                                   metric))
            _assert_same_lists(ops.knn_graph(X, k=15, metric=metric),
                               knn_topk_cuda(X, X, ids, ids, k=15,
                                             metric=metric))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_knn_kernel_query_candidate_form(cuda, metric):
    """Sentinel query ids (no self mask), padded candidates (cid < 0), a
    cell with fewer valid candidates than k, and the blocked route
    (k > MAX_K) giving the kernel's lists on the same tile values."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    Xq = torch.randn(300, 7, device=cuda, generator=gen)
    Xc = torch.randn(90, 7, device=cuda, generator=gen)
    no_id = torch.full((300,), -1, dtype=torch.int64, device=cuda)
    cid = torch.arange(90, device=cuda)
    for k in (2, 15, 128):
        _assert_same_lists(knn_topk_cuda(Xq, Xc, no_id, cid, k=k,
                                         metric=metric),
                           _plain_knn(Xq, Xc, no_id, cid, k, metric))
    padded = torch.where(cid % 4 == 0, -1, cid + 1000)
    qid = torch.arange(1000, 1300, device=cuda)     # some match a candidate
    got = knn_topk_cuda(Xq, Xc, qid, padded, k=128, metric=metric)
    _assert_same_lists(got, _plain_knn(Xq, Xc, qid, padded, 128, metric))
    assert bool((got[1][:, 67:] == -1).all())        # 67 valid at most
    assert bool(torch.isinf(got[0][:, 67:]).all())
    for k in (15, 100):
        _assert_same_lists(
            knn_topk_blocked(Xq, Xc, qid, padded, k=k, metric=metric,
                             rows=64, cols=32),
            knn_topk_cuda(Xq, Xc, qid, padded, k=k, metric=metric))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 17, 64, 65])
def test_cuda_knn_kernel_tile_edges(cuda, d):
    """The exact graph == the pairwise kernel's sorted rows where the tile
    engine has edges: n not a multiple of the 128 x 64 tile, every staging
    depth (d <= 8, <= 16, above, ragged past a chunk), both copy widths
    (an aligned base with d % 4 == 0 takes 16-byte copies; the same points
    one float off alignment take 4-byte ones), k in {1, 15, 128}."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n = 333
    X = torch.randn(n, d, device=cuda, generator=gen)
    Xo = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    Xo.copy_(X)
    ids = torch.arange(n, device=cuda)
    for k in (1, 15, 128):
        want = _plain_knn(X, X, ids, ids, k, "euclidean")
        _assert_same_lists(knn_topk_cuda(X, X, ids, ids, k=k), want)
        _assert_same_lists(knn_topk_cuda(Xo, Xo, ids, ids, k=k), want)


def _segments(gen, device, d):
    """Segments of a segmented kNN call: a cell with queries and no
    candidates, one with candidates and no queries, cells with fewer
    candidates than 15 and with several tiles of them, queries that are
    their own candidates, padded candidates and sentinel query ids."""
    sizes = [(40, 0), (0, 30), (25, 3), (300, 14), (131, 200), (9, 1),
             (700, 450)]
    qoff = torch.tensor([0] + np.cumsum([q for q, _ in sizes]).tolist(),
                        device=device)
    coff = torch.tensor([0] + np.cumsum([c for _, c in sizes]).tolist(),
                        device=device)
    Xc = torch.randn(int(coff[-1]), d, device=device, generator=gen)
    cid = torch.randperm(100_000, device=device, generator=gen)[:Xc.shape[0]]
    cid[::11] = -1
    Xq = torch.randn(int(qoff[-1]), d, device=device, generator=gen)
    qid = torch.randperm(100_000, device=device, generator=gen)[:Xq.shape[0]]
    qid[::5] = -1
    for g, (q, c) in enumerate(sizes):
        q0, c0, own = int(qoff[g]), int(coff[g]), min(q, c) // 2
        Xq[q0:q0 + own] = Xc[c0:c0 + own]
        qid[q0:q0 + own] = cid[c0:c0 + own]
    return Xq, Xc, qid, cid, qoff, coff


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_knn_segmented_equals_per_cell_kernel(cuda, metric):
    """One segmented launch == the kNN kernel cell by cell, bit for bit, at
    d = 8 (one staging pass) and d = 13 (4-byte copies); an empty cell's
    rows and the slots a short cell cannot fill hold (+inf, -1)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for d in (8, 13):
        Xq, Xc, qid, cid, qoff, coff = _segments(gen, cuda, d)
        for k in (1, 15, 128):
            _build.reset_launch_counts()
            got = knn_topk_segmented_cuda(Xq, Xc, qid, cid, qoff, coff, k=k,
                                          metric=metric)
            assert _build.launch_counts()["knn_graph_segmented"] == 1
            _assert_same_lists(ops.knn_topk_segmented(
                Xq, Xc, qid, cid, qoff, coff, k=k, metric=metric), got)
            for g in range(qoff.numel() - 1):
                q0, q1 = int(qoff[g]), int(qoff[g + 1])
                c0, c1 = int(coff[g]), int(coff[g + 1])
                if q1 == q0:
                    continue
                rows = (got[0][q0:q1], got[1][q0:q1])
                if c1 == c0:
                    assert bool(torch.isinf(rows[0]).all())
                    assert bool((rows[1] == -1).all())
                    continue
                _assert_same_lists(rows, knn_topk_cuda(
                    Xq[q0:q1], Xc[c0:c1], qid[q0:q1], cid[c0:c1], k=k,
                    metric=metric))


@pytest.mark.cuda
def test_cuda_anchored_graph_in_two_launches(cuda):
    """The anchored search on the card: one assignment launch and one
    segmented launch, and on integer data (every value exact in f32) the
    CPU path's graph, bit for bit."""
    rng = np.random.default_rng(3)
    X = np.concatenate([rng.integers(-4, 5, size=(3000, 4)) + 40 * c
                        for c in range(4)]).astype(np.float32)
    _build.reset_launch_counts()
    got = core.knn_graph_anchored(torch.from_numpy(X).to(cuda), k=9)
    counts = _build.launch_counts()
    assert counts["knn_graph"] == 1 and counts["knn_graph_segmented"] == 1
    want = core.knn_graph_anchored(torch.from_numpy(X), k=9)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _prim_matrices(device):
    """Prim-order inputs: float blobs (the pairwise kernel's matrices),
    tie-heavy squared distances of integer points with duplicates, and the
    same with every zero off the diagonal of half the rows made -0.0."""
    gen = torch.Generator(device=device).manual_seed(4)
    out = []
    for n in (1, 2, 3, 129, 2048):
        X = torch.from_numpy(_contig_blobs(n, d=5, seed=n)).to(device)
        out.append(ops.pairwise_dist(X))
        P = torch.randint(-2, 3, (n, 3), device=device, generator=gen).float()
        R = torch.sum((P[:, None] - P[None]) ** 2, dim=-1)
        out.append(R)
        Rz = R.clone()
        zero = (Rz == 0) & (torch.arange(n, device=device) % 2 == 0)[:, None]
        Rz[zero] = -0.0
        out.append(Rz)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 16])
def test_cuda_vat_prim_order_equals_the_loop(cuda, cluster):
    """The one-launch Prim kernel == the loop of plain masked argmins on the
    same card matrix, bit for bit, at the cluster size the host picks, one
    CTA and 16 CTAs a matrix, rows holding both signed zeros included."""
    for R in _prim_matrices(cuda):
        i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
        got = vat_prim_order_cuda(R, i0, cluster=cluster)
        want = ref.vat_prim_order_ref(R, i0)
        assert torch.equal(got, want), (R.shape, cluster)
        assert torch.equal(vat_order(R), want)


@pytest.mark.cuda
def test_cuda_vat_prim_order_lanes_equal_solo(cuda):
    """Eight lanes in one launch == their solo launches, bit for bit, and
    vat_order_batch makes one launch a stack."""
    mats = [m for m in _prim_matrices(cuda) if m.shape[0] == 129][:3]
    stack = torch.stack([mats[z % 3] for z in range(8)])
    gen = torch.Generator(device=cuda).manual_seed(8)
    stack[3:] += torch.rand(5, 129, 129, device=cuda, generator=gen).round()
    i0 = torch.argmax(torch.amax(stack, dim=2), dim=1)
    _build.reset_launch_counts()
    lanes = core.vat_order_batch(stack)
    assert _build.launch_counts()["vat_prim_order"] == 1
    for z in range(8):
        solo = vat_prim_order_cuda(stack[z].contiguous(), i0[z:z + 1])
        assert torch.equal(lanes[z], solo)
    assert torch.equal(lanes, ref.vat_prim_order_ref(stack, i0))


_PRIM_WANT = {}


def _prim_cases(n, device):
    """(name, R, i0, the loop's order) at n: float, tie-heavy integer and
    signed-zero matrices, the loop run once a matrix for every test."""
    if n not in _PRIM_WANT:
        gen = torch.Generator(device=device).manual_seed(n)
        P = torch.randint(-3, 4, (n, 3), device=device, generator=gen).float()
        Ri = torch.sum((P[:, None] - P[None]) ** 2, dim=-1)
        Rz = Ri.clone()
        Rz[(Rz == 0) & (torch.arange(n, device=device) % 2 == 0)[:, None]] \
            = -0.0
        X = torch.randn(n, 16, device=device, generator=gen)
        cases = []
        for name, R in (("float", ops.pairwise_dist(X)), ("int", Ri),
                        ("signed_zero", Rz)):
            i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
            cases.append((name, R, i0, ref.vat_prim_order_ref(R, i0)))
        _PRIM_WANT[n] = cases
    return _PRIM_WANT[n]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 129, 2047, 2048])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cuda_vat_prim_order_cluster_size_changes_no_bit(cuda, cluster, n):
    """Every cluster size, the rows read by loads and (n % 4 == 0) by the
    bulk copy, gives the loop's order bit for bit: float, integer
    (tie-heavy) and signed-zero matrices, n that C does not divide, and
    C > n (CTAs with no lane).  ``tools/prim_order_phases.py`` holds 128
    to 1,024 threads a CTA against the same order."""
    from repro_torch.kernels.prim_update import prim_bulk
    for name, R, i0, want in _prim_cases(n, cuda):
        for bulk in (False, True) if prim_bulk(n, cluster) else (False,):
            got = vat_prim_order_cuda(R, i0, cluster=cluster, bulk=bulk)
            assert torch.equal(got, want), (name, bulk)


@pytest.mark.cuda
def test_cuda_vat_prim_order_bulk_copy_needs_aligned_rows(cuda):
    """R at an address that is not 16-byte aligned, or n % 4 != 0, refuses
    the bulk row copy when it is asked for, and the host's choice reads the
    rows by loads: the loop's order either way."""
    name, R, i0, want = _prim_cases(2048, cuda)[1]
    buf = torch.empty(R.numel() + 1, device=cuda)
    shifted = buf[1:].view(R.shape)
    shifted.copy_(R)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="bulk row copy"):
        vat_prim_order_cuda(shifted, i0, cluster=8, bulk=True)
    assert torch.equal(vat_prim_order_cuda(shifted, i0, cluster=8), want)
    assert torch.equal(vat_prim_order_cuda(R, i0, cluster=8, bulk=True), want)
    _, R7, i07, want7 = _prim_cases(2047, cuda)[1]
    with pytest.raises(ValueError, match="bulk row copy"):
        vat_prim_order_cuda(R7, i07, cluster=8, bulk=True)


@pytest.mark.cuda
def test_cuda_vat_prim_order_past_one_slice(cuda):
    """n = 40,961 is more than one CTA's shared memory holds: one CTA is
    refused, clusters of 2 and the host's choice give the loop's order."""
    from repro_torch.kernels.prim_update import SLICE_MAX
    n = SLICE_MAX + 1
    gen = torch.Generator(device=cuda).manual_seed(n)
    P = torch.randint(-3, 4, (n, 3), device=cuda, generator=gen).float()
    R = pairwise_dist_cuda(P, metric="sqeuclidean").fill_diagonal_(0.0)
    i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
    with pytest.raises(ValueError, match="cluster must be one of"):
        vat_prim_order_cuda(R, i0, cluster=1)
    want = vat_order(R, argmin=ref.masked_argmin_ref)
    for cluster in (2, None):
        assert torch.equal(vat_prim_order_cuda(R, i0, cluster=cluster), want)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [2, 8, 16])
def test_cuda_vat_prim_order_lanes_equal_solo_under_clusters(cuda, cluster):
    """Eight lanes of clusters in one launch == their solo launches at the
    same C and the host's C, bit for bit; ``vat_order_batch`` makes one
    launch of the stack and gives the same lanes."""
    cases = _prim_cases(2048, cuda)
    stack = torch.stack([cases[z % 3][1] for z in range(8)])
    gen = torch.Generator(device=cuda).manual_seed(cluster)
    stack[3:] += torch.rand(5, 2048, 2048, device=cuda, generator=gen).round()
    i0 = torch.argmax(torch.amax(stack, dim=2), dim=1)
    lanes = vat_prim_order_cuda(stack, i0, cluster=cluster)
    _build.reset_launch_counts()
    assert torch.equal(core.vat_order_batch(stack), lanes)
    assert _build.launch_counts()["vat_prim_order"] == 1
    for z in range(8):
        for c in (cluster, None):
            solo = vat_prim_order_cuda(stack[z].contiguous(), i0[z:z + 1],
                                       cluster=c)
            assert torch.equal(lanes[z], solo), (z, c)
    assert torch.equal(lanes, ref.vat_prim_order_ref(stack, i0))


@pytest.mark.cuda
def test_cuda_vat_prim_order_clusters_in_waves(cuda):
    """A stack of more 16-CTA clusters than the device holds at once runs
    in waves; every lane still equals its solo launch."""
    from repro_torch.kernels.prim_update import _resident_clusters, prim_plan
    n = 129
    _, threads, bulk = prim_plan(n, cluster=16)
    held = _resident_clusters(16, n, threads, bulk)
    assert held >= 1
    b = 2 * held + 3
    cases = _prim_cases(n, cuda)
    stack = torch.stack([cases[z % 3][1] for z in range(b)])
    gen = torch.Generator(device=cuda).manual_seed(b)
    stack += torch.rand(b, n, n, device=cuda, generator=gen).round()
    i0 = torch.argmax(torch.amax(stack, dim=2), dim=1)
    lanes = vat_prim_order_cuda(stack, i0, cluster=16)
    for z in range(b):
        assert torch.equal(lanes[z], vat_prim_order_cuda(
            stack[z].contiguous(), i0[z:z + 1], cluster=16)), z
    assert torch.equal(lanes, ref.vat_prim_order_ref(stack, i0))


@pytest.mark.cuda
@pytest.mark.parametrize("connected", [True, False])
def test_cuda_boruvka_equals_cpu_boruvka(cuda, connected):
    """The passes on the card and on the CPU, fed the same (idx, dist),
    give the same tree bit for bit (the repair uses the same X)."""
    X = (np.random.default_rng(0).random((3000, 5)).astype(np.float32)
         if connected else _contig_blobs(3000, d=5, k=6, sep=4000.0))
    X = torch.from_numpy(X).to(cuda)
    dist, idx = ops.knn_graph(X, k=10 if connected else 3)
    got = core.boruvka_mst(idx, dist, X=X)
    want = core.boruvka_mst(idx.cpu(), dist.cpu(), X=X)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1:] == want[1:]
    assert (got[2] == 1) == connected


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_full_k_approx_equals_flashvat_and_vat(cuda, metric):
    """k = n-1: the approx order is exact Prim's on the card, bit for bit —
    through the kernel at n = 129 and the blocked route at n = 1,024."""
    from repro_torch import FastVAT
    for n in (129, 1024):
        X = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
        _build.reset_launch_counts()
        fa = FastVAT(method="approx", knn_k=n - 1, metric=metric).fit(X)
        launched = _build.launch_counts()["knn_graph"]
        assert launched == (1 if n - 1 <= MAX_K else 0)
        ff = FastVAT(method="flashvat", metric=metric).fit(X)
        fv = FastVAT(method="vat", metric=metric).fit(X)
        np.testing.assert_array_equal(fa.order(), ff.order())
        np.testing.assert_array_equal(fa.order(), fv.order())
        assert fa.result.meta.approx.components == 1


@pytest.mark.cuda
def test_cuda_approx_fit_launches_its_kernels(cuda):
    from repro_torch import FastVAT
    X = _contig_blobs(3000, d=6)
    _build.reset_launch_counts()
    fv = FastVAT(method="approx").fit(X)
    counts = _build.launch_counts()
    s = fv.result.meta.approx
    assert s.mode == "exact" and s.k == 15
    assert counts["knn_graph"] == 1 and counts["prim_persist"] == 0
    assert counts["prim_stream_step"] == 0
    assert counts["vat_prim_order"] == 1 and counts["masked_argmin"] == 0
    assert counts["ivat_from_vat"] == 1
    # the band render, and the repair's one matrix if the graph split
    assert counts["pairwise_dist"] == 1 + (s.components > 1)
    assert fv.result.order.is_cuda
    assert sorted(fv.order().tolist()) == list(range(3000))
    rep = fv.assess()
    assert rep.k_est == 4 and rep.clustered


# ------------------------------------------------ the batched kernels ----

@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
@pytest.mark.parametrize("b,n,d", [(1, 301, 7), (3, 17, 70), (8, 67, 3),
                                   (2, 257, 64), (8, 1500, 33)])
def test_cuda_pairwise_batch_against_plain_and_solo(cuda, metric, form, b,
                                                    n, d):
    """b = 1, 3, 8 at odd n and n below one tile: within the pairwise
    tolerance of the stacked plain version, zero diagonals, and each lane
    the single kernel's matrix bit for bit (f32 and bf16 storage).  At
    (8, 1500) the batch takes tiles of 128 and the solo call tiles of 64:
    the tile changes no bit."""
    gen = torch.Generator(device=cuda).manual_seed(4 + n)
    X = torch.randn(b, n, d, device=cuda, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        Xc = X.to(dtype)
        got = pairwise_dist_batch_cuda(Xc, metric=metric, form=form)
        want = ref.pairwise_dissim_batch_ref(Xc, metric=metric, form=form)
        tol = _tolerance(metric, form, Xc.float().view(b * n, d), None,
                         want)
        assert float(torch.amax(torch.abs(got - want))) <= tol
        assert not bool(torch.diagonal(got, dim1=1, dim2=2).any())
        for z in range(b):
            assert torch.equal(got[z], ops.pairwise_dist(
                Xc[z], metric=metric, form=form))


@pytest.mark.cuda
def test_cuda_masked_argmin_lane_axis_bitwise(cuda):
    """A (b, n) stack in one launch pair: each row the plain argmin and the
    single kernel's pair, bit for bit, above and below one CTA's 4,096."""
    for b in (1, 3, 8):
        for n in (17, 4096, 4097, 20000):
            rng = np.random.default_rng(b * n)
            vals = torch.from_numpy(rng.integers(-5, 6, size=(b, n)).astype(
                np.float32)).to(cuda)
            mask = torch.from_numpy(rng.random((b, n)) < 0.5).to(cuda)
            mask[-1] = True                        # a fully masked lane
            kv, ki = masked_argmin_cuda(vals, mask)
            pv, pi = ref.masked_argmin_ref(vals, mask)
            assert torch.equal(ki, pi) and torch.equal(kv, pv)
            for z in range(b):
                sv, si = masked_argmin_cuda(vals[z], mask[z])
                assert int(si) == int(ki[z]) and torch.equal(sv, kv[z])


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_prim_stream_step_batch_against_plain_and_solo(cuda, metric,
                                                            form):
    """Each lane's frontier within the pairwise tolerance of the plain
    step, its pair the plain argmin of its own frontier, and the whole
    lane the single kernel's step bit for bit (one CTA at n = 17, several
    at n = 1,000)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for b, n in ((1, 1000), (3, 17), (4, 1000)):
        X = torch.randn(b, n, 19, device=cuda, generator=gen)
        aux = metric_aux_cuda(X, metric=metric)
        mind = torch.rand(b, n, device=cuda, generator=gen) * 4.0
        sel = torch.rand(b, n, device=cuda, generator=gen) < 0.3
        q = torch.randint(0, n, (b,), device=cuda, generator=gen)
        want, _, _ = ref.prim_stream_step_batch_ref(X, aux, q, mind.clone(),
                                                    sel, metric=metric,
                                                    form=form)
        solo = [prim_stream_step_cuda(X[z], aux[z], q[z:z + 1],
                                      mind[z].clone(), sel[z], metric=metric,
                                      form=form) for z in range(b)]
        got, ev, nq = prim_stream_step_batch_cuda(X, aux, q, mind, sel,
                                                  metric=metric, form=form)
        tol = _tolerance(metric, form, X.view(b * n, -1), None, want)
        assert float(torch.amax(torch.abs(got - want))) <= tol
        pv, pi = ref.masked_argmin_ref(got, sel)
        assert torch.equal(nq, pi) and torch.equal(ev, pv)
        for z, (sm, se, sq) in enumerate(solo):
            assert torch.equal(got[z], sm) and torch.equal(ev[z], se)
            assert int(nq[z]) == int(sq)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_prim_persist_lanes_equal_solo_launches(cuda, metric):
    """b persistent CTAs in one launch: every lane's order, edges and
    stats equal a single launch on that lane, pruned and eager, for a
    ragged and a below-one-tile n."""
    for b, n, block in ((3, 500, 64), (1, 700, 1024), (4, 40, 64)):
        X = torch.from_numpy(np.stack([_contig_blobs(n, seed=s)
                                       for s in range(b)])).to(cuda)
        aux = metric_aux_cuda(X, metric=metric)
        i0 = torch.stack([_streamed_seed_pivot(x, metric=metric) for x in X])
        for prune in (True, False):
            order, edges, stats = prim_persist_cuda(
                X, aux, i0, metric=metric, block=block, prune=prune)
            assert order.shape == edges.shape == (b, n)
            for z in range(b):
                so, se, ss = prim_persist_cuda(X[z], aux[z], i0[z],
                                               metric=metric, block=block,
                                               prune=prune)
                assert torch.equal(order[z], so) and torch.equal(edges[z], se)
                assert torch.equal(stats[z], ss)


def _persist_inputs(X, metric="euclidean"):
    aux = metric_aux_cuda(X, metric=metric)
    if X.dim() == 3:
        return aux, torch.stack([_streamed_seed_pivot(x, metric=metric)
                                 for x in X])
    return aux, _streamed_seed_pivot(X, metric=metric)


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(40, 8), (700, 32)])
def test_cuda_prim_persist_group_size_changes_no_bit(cuda, n, block):
    """The same traversal on groups of 1 to nblk CTAs, some of them owning
    no tile (ceil(nblk / G) tiles a CTA): order, edges and all four stats
    equal, pruned and eager; one barrier a step."""
    from repro_torch.kernels.prim_persist import persist_plan
    X = torch.from_numpy(_contig_blobs(n)).to(cuda)
    aux, i0 = _persist_inputs(X)
    nblk = -(-n // block)
    for prune in (True, False):
        want = prim_persist_cuda(X, aux, i0, block=block, prune=prune,
                                 max_group=1)
        assert int(want[2][3]) == n - 1
        idle = False
        for cap in (2, 3, 4, 12, 15, None):
            plan = persist_plan(1, n, 3, block=block, max_group=cap)
            assert plan["group"] == min(cap or nblk, nblk)
            tpc = plan["tiles_per_cta"]
            idle |= (plan["group"] - 1) * tpc >= nblk
            got = prim_persist_cuda(X, aux, i0, block=block, prune=prune,
                                    max_group=cap)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (cap, prune)
        assert idle   # some group left a CTA without a tile


@pytest.mark.cuda
def test_cuda_prim_persist_group_of_one_route(cuda):
    """b past the co-resident CTAs gives G = 1 (a plain launch, the
    exchange a __syncthreads()); every lane equals its solo launch, which
    spreads over a group of CTAs."""
    from repro_torch.kernels.prim_persist import persist_plan
    b, n, d, block = 600, 40, 3, 8
    assert persist_plan(b, n, d, block=block)["group"] == 1
    assert persist_plan(1, n, d, block=block)["group"] == 5
    X = torch.from_numpy(np.stack([_contig_blobs(n, seed=s)
                                   for s in range(b)])).to(cuda)
    aux, i0 = _persist_inputs(X)
    for prune in (True, False):
        order, edges, stats = prim_persist_cuda(X, aux, i0, block=block,
                                                prune=prune)
        for z in range(b):
            so, se, ss = prim_persist_cuda(X[z], aux[z], i0[z], block=block,
                                           prune=prune)
            assert torch.equal(order[z], so) and torch.equal(edges[z], se)
            assert torch.equal(stats[z], ss)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(50_000, 64), (20_000, 1024)])
def test_cuda_prim_persist_rows_staged_and_in_global(cuda, n, d):
    """Rows in shared memory (d = 64, the default group) and in global
    memory (a group of 8 CTAs at d = 64; every group at d = 1,024): the
    same bits, and the stepwise engine's order and edges."""
    from repro_torch.kernels.prim_persist import persist_plan
    X = torch.from_numpy(_contig_blobs(n, d=d, k=8)).to(cuda)
    aux, i0 = _persist_inputs(X)
    plan = persist_plan(1, n, d)
    assert plan["rows_staged"] == (d == 64)
    got = prim_persist_cuda(X, aux, i0)
    eager = prim_persist_cuda(X, aux, i0, prune=False)
    assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
    if d == 64:
        assert not persist_plan(1, n, d, max_group=8)["rows_staged"]
        in_global = prim_persist_cuda(X, aux, i0, max_group=8)
        for a, b in zip(in_global, got):
            assert torch.equal(a, b)
    stepw = core.vat_matrix_free(X, turbo=False)
    assert torch.equal(got[0], stepw.order)
    assert torch.equal(got[1], stepw.edges)
    assert int(got[2][2]) == int(eager[2][2]) == n * (n - 1) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4096, 2048), (20_000, 1024)])
def test_cuda_prim_persist_rows_in_global_against_plain(cuda, n, d):
    """Rows past shared memory (the embed path's d = 2,048 at 4,096 rows,
    and d = 1,024) against ``ref.prim_persist_ref`` on the same tensors:
    by spanning-tree weight (EXCESS_F32 = 1e-5) and by the edges as
    multisets within the pairwise tolerance."""
    from repro_torch.kernels.prim_persist import persist_plan
    X = torch.from_numpy(_contig_blobs(n, d=d, k=8)).to(cuda)
    aux, i0 = _persist_inputs(X)
    assert not persist_plan(1, n, d)["rows_staged"]
    order, edges, _ = prim_persist_cuda(X, aux, i0, prune=False)
    porder, pedges = ref.prim_persist_ref(X, aux, i0)
    R = torch.cdist(X.double(), X.double())
    wk = float(torch.sum(_frontier_minima(R, order)))
    wp = float(torch.sum(_frontier_minima(R, porder)))
    assert abs(wk - wp) / wp <= 1e-5
    assert float(torch.amax(torch.abs(torch.sort(edges).values
                                      - torch.sort(pedges).values))) <= \
        _tolerance("euclidean", "gram", X, None, edges)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_knn_batch_equals_solo_and_plain(cuda, metric):
    """Each lane's lists are the single kernel's and the pairwise kernel's
    sorted rows, bit for bit, at ragged n, n below one tile, and k up to
    MAX_K; k > MAX_K takes the blocked route lane by lane."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for b, n, d, k in ((1, 257, 64, 15), (3, 40, 3, 39), (4, 300, 9, 128)):
        X = torch.randn(b, n, d, device=cuda, generator=gen)
        ids = torch.arange(n, device=cuda)
        got = knn_graph_batch_cuda(X, k=k, metric=metric)
        for z in range(b):
            _assert_same_lists((got[0][z], got[1][z]),
                               knn_topk_cuda(X[z], X[z], ids, ids, k=k,
                                             metric=metric))
            _assert_same_lists((got[0][z], got[1][z]),
                               _plain_knn(X[z], X[z], ids, ids, k, metric))
    X = torch.randn(2, 200, 5, device=cuda, generator=gen)
    big = ops.knn_graph_batch(X, k=150, metric=metric)
    for z in range(2):
        _assert_same_lists((big[0][z], big[1][z]),
                           ops.knn_graph(X[z], k=150, metric=metric))


@pytest.mark.cuda
@pytest.mark.parametrize("method,turbo", [("vat", None), ("ivat", None),
                                          ("flashvat", None),
                                          ("flashvat", False)])
def test_cuda_fit_many_lanes_equal_solo_fits(cuda, method, turbo):
    """fit_many on the card: the batched kernels' launch counts, and every
    lane's order, image and report the solo fit's, bit for bit."""
    from repro_torch import FastVAT
    b, n = 3, 300
    Xs = np.stack([_contig_blobs(n, d=4, seed=s) for s in range(b)])
    _build.reset_launch_counts()
    fv = FastVAT(method=method, turbo=turbo, sample_size=64).fit_many(Xs)
    counts = _build.launch_counts()
    if method == "flashvat":
        assert counts["prim_persist"] == (1 if turbo is None else 0)
        assert counts["prim_stream_step_batch"] == (
            0 if turbo is None else n - 1)
        assert counts["pairwise_dist_batch"] == 1     # the render
        assert counts["vat_prim_order"] == 1 and counts["ivat_from_vat"] == 1
        assert counts["masked_argmin"] == 0
    else:
        assert counts["pairwise_dist_batch"] == 1
        assert counts["vat_prim_order"] == 1 and counts["masked_argmin"] == 0
        assert counts["ivat_from_vat"] == (1 if method == "ivat" else 0)
    assert fv.result.order.is_cuda and fv.batched
    reps = fv.assess()
    for z in range(b):
        solo = FastVAT(method=method, turbo=turbo, sample_size=64).fit(Xs[z])
        np.testing.assert_array_equal(fv.order()[z], solo.order())
        np.testing.assert_array_equal(fv.image(use_ivat=True)[z],
                                      solo.image(use_ivat=True))
        srep = solo.assess()
        assert (reps[z].block_score, reps[z].k_est) == (srep.block_score,
                                                        srep.k_est)
    if method in ("vat", "ivat"):
        Ds = ops.pairwise_dist_batch(
            fv._X, form=fv.result.meta.numerics.form).cpu().numpy()
        fp = FastVAT(method=method, metric="precomputed").fit_many(Ds)
        np.testing.assert_array_equal(fp.order(), fv.order())


# ---------------------------------------- the one-launch step kernels ----

#: (n, d) of the step kernels' cases: one lane, one CTA of 128 and its
#: edges, two CTAs, and the flash path's n; d not a multiple of 4 and 64.
STEP_SHAPES = [(n, d) for n in (1, 127, 128, 129, 255, 256, 257, 50_000)
               for d in (5, 7, 64)]
METRIC_FORMS = (("euclidean", "gram"), ("sqeuclidean", "gram"),
                ("cosine", "gram"), ("euclidean", "direct"),
                ("sqeuclidean", "direct"), ("manhattan", "direct"))


def _step_tolerance(metric, form, X, want):
    """``_tolerance``, and for gram-form sqeuclidean at least the Gram
    cancellation floor itself (16 eps max |x|^2): a row near 0, such as a
    lane's distance to itself, carries that absolute error whatever its
    size."""
    tol = _tolerance(metric, form, X, None, want)
    if metric == "sqeuclidean" and form == "gram":
        sq = float(torch.amax(torch.sum(X.double() ** 2, dim=1)))
        tol = max(tol, 16 * F32_EPS * sq)
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", STEP_SHAPES)
@pytest.mark.parametrize("metric,form", METRIC_FORMS)
def test_cuda_one_launch_step_against_plain(cuda, metric, form, n, d):
    """The step in one launch against ``ref.prim_stream_step_ref``: the
    frontier within the pairwise tolerance, the pair the plain argmin of the
    kernel's own frontier bit for bit (±0.0 and +inf lanes included); one
    launch a call; and the recording step (the engines' entry) gives the
    parity entry's frontier and pair bit for bit and marks its vertex."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    X = torch.randn(n, d, device=cuda, generator=gen)
    aux = metric_aux_cuda(X, metric=metric)
    u = torch.rand(n, device=cuda, generator=gen)
    mind = torch.where(u < 0.1, torch.inf, torch.where(
        u < 0.2, -0.0, 4.0 * torch.rand(n, device=cuda, generator=gen)))
    sel = torch.rand(n, device=cuda, generator=gen) < 0.3
    q = torch.tensor([n // 3], device=cuda)
    want, _, _ = ref.prim_stream_step_ref(X, aux, q, mind.clone(), sel,
                                          metric=metric, form=form)
    rmind, rsel = mind.clone(), sel.clone()
    _build.reset_launch_counts()
    got, ev, nq = prim_stream_step_cuda(X, aux, q, mind, sel, metric=metric,
                                        form=form)
    assert _build.launch_counts()["prim_stream_step"] == 1
    fin = torch.isfinite(want)
    assert torch.equal(torch.isinf(got), ~fin)
    if bool(fin.any()):
        tol = _step_tolerance(metric, form, X, want[fin])
        assert float(torch.amax(torch.abs(got[fin] - want[fin]))) <= tol
    pv, pi = ref.masked_argmin_ref(got, sel)
    assert int(nq) == int(pi) and torch.equal(ev.view(1), pv.view(1))
    assert torch.equal(torch.signbit(ev), torch.signbit(pv))
    if n > 1:
        order = torch.zeros(n, dtype=torch.int64, device=cuda)
        order[0] = q[0]
        edges = torch.zeros(n, device=cuda)
        StreamRecord(X, aux, rmind, rsel, order, edges, metric=metric,
                     form=form)(1)
        assert torch.equal(rmind, got)
        assert int(order[1]) == int(nq)
        assert torch.equal(edges[1].view(1), ev.view(1))
        assert torch.equal(torch.signbit(edges[1]), torch.signbit(ev))
        sel[int(nq)] = True
        assert torch.equal(rsel, sel)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [70_000, 2 ** 31 + 5, None])
@pytest.mark.parametrize("n,d", STEP_SHAPES)
@pytest.mark.parametrize("metric,form", METRIC_FORMS)
def test_cuda_one_launch_frontier_against_plain(cuda, metric, form, n, d,
                                                offset):
    """The frontier step in one launch against
    ``ref.prim_frontier_round_ref``: the pivot recorded exactly, its lane
    closed, +inf lanes (selected and padding) never revived, the other lanes
    within the pairwise tolerance, and the new slot the kernel's own
    first-index minimum bit for bit, with global ids past 2^31 and up to
    2^32 - 1 (offset None: the last shard that fits)."""
    gen = torch.Generator(device=cuda).manual_seed(3 * n + d)
    offset = 2 ** 32 - 1 - n if offset is None else offset
    X = torch.randn(n, d, device=cuda, generator=gen)
    aux = metric_aux_cuda(X, metric=metric)
    width = ref.slot_width(d)
    piv = n // 2

    def slot(v, gid, local):
        return ref.make_slot(torch.tensor(v, device=cuda),
                             torch.tensor(gid, device=cuda),
                             torch.tensor(v, device=cuda), aux[local],
                             X[local], width)

    table = torch.stack([slot(7.0, 3, 0), slot(2.5, offset + piv, piv),
                         slot(2.5, 2 ** 32 - 1, 0)])
    u = torch.rand(n, device=cuda, generator=gen)
    mind = torch.where(u < 0.3, torch.inf, torch.where(
        u < 0.6, ref.UNSEEN, 50.0 * torch.rand(n, device=cuda,
                                               generator=gen)))
    order = torch.zeros(4, dtype=torch.int64, device=cuda)
    edges = torch.zeros(4, device=cuda)
    porder, pedges = order.clone(), edges.clone()
    want, _ = ref.prim_frontier_round_ref(
        X, aux, table, mind.clone(), porder, pedges, 3, offset=offset,
        metric=metric, form=form)
    was_inf = torch.isinf(mind)
    out = torch.empty(width, device=cuda)
    _build.reset_launch_counts()
    got = prim_frontier_step_cuda(X, aux, table, mind, out, order, edges, 3,
                                  offset=offset, metric=metric, form=form)
    assert _build.launch_counts()["prim_frontier_step"] == 1
    assert torch.equal(order, porder) and torch.equal(edges, pedges)
    assert int(order[3]) == offset + piv and float(edges[3]) == 2.5
    assert torch.isinf(got[piv]) and torch.all(torch.isinf(got[was_inf]))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = ~torch.isinf(got)
    if bool(fin.any()):
        tol = _step_tolerance(metric, form, X, want[fin])
        assert float(torch.amax(torch.abs(got[fin] - want[fin]))) <= tol
    i = int(torch.argmin(got))
    assert int(ref.slot_id(out)) == offset + i
    assert torch.equal(out[:2].view(torch.int64), ref.signed_key(
        got[i], torch.tensor(offset + i, device=cuda)).view(1))
    assert torch.equal(out[2:4], torch.stack([got[i], aux[i]]))
    assert torch.equal(out[4:4 + d], X[i]) and torch.all(out[4 + d:] == 0)


def _loop_of_single_steps(X, aux, i0, metric, form):
    """The stepwise traversal as a loop of parity calls, each with its own
    scratch, the record kept by torch ops."""
    n = X.shape[0]
    q = i0.view(1)
    mind = torch.full((n,), torch.inf, device=X.device)
    sel = torch.zeros(n, dtype=torch.bool, device=X.device)
    sel[q] = True
    order = torch.zeros(n, dtype=torch.int64, device=X.device)
    order[0:1] = q
    edges = torch.zeros(n, device=X.device)
    for t in range(1, n):
        mind, ev, nq = prim_stream_step_cuda(X, aux, q, mind, sel,
                                             metric=metric, form=form)
        q = nq.view(1)
        sel[q] = True
        order[t:t + 1] = q
        edges[t:t + 1] = ev.view(1)
    return order, edges


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 128, 129, 1000])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_record_steps_reuse_one_scratch(cuda, metric, n):
    """n - 1 recording steps on one scratch (every ticket reset by the step
    that drew it, one CTA or eight) give the loop of parity calls' order and
    edges, and the persistent kernel's, bit for bit; one launch a step;
    then the frontier step, n steps on one scratch over a world of one
    (the table refilled from the slot), gives them too."""
    X = torch.randn(n, 6, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(n))
    aux = metric_aux_cuda(X, metric=metric)
    i0 = _streamed_seed_pivot(X, metric=metric)
    want_o, want_e = _loop_of_single_steps(X, aux, i0, metric, "gram")
    _build.reset_launch_counts()
    got = core.vat_matrix_free(X, metric=metric, turbo=False)
    assert _build.launch_counts()["prim_stream_step"] == n - 1
    assert torch.equal(got.order, want_o) and torch.equal(got.edges, want_e)
    turbo = core.vat_matrix_free(X, metric=metric)
    assert torch.equal(got.order, turbo.order)
    assert torch.equal(got.edges, turbo.edges)
    width = ref.slot_width(X.shape[1])
    zero = torch.zeros((), device=cuda)
    table = ref.make_slot(zero, i0, zero, aux[i0], X[i0], width).view(1, -1)
    slot = torch.empty(width, device=cuda)
    mind = torch.full((n,), ref.UNSEEN, device=cuda)
    order = torch.empty(n, dtype=torch.int64, device=cuda)
    edges = torch.empty(n, device=cuda)
    step = FrontierStep(X, aux, table, mind, slot, order, edges,
                        metric=metric)
    for t in range(n):
        step(t)
        table.copy_(slot.view(1, -1))
    assert _build.launch_counts()["prim_frontier_step"] == n
    assert torch.equal(order, want_o) and torch.equal(edges, want_e)


@pytest.mark.cuda
def test_cuda_record_traversals_interleaved_on_two_streams(cuda):
    """Two traversals, each with its own step object and scratch, built and
    stepped on two streams in turns (a step of one, then of the other,
    never waiting): each equals its traversal alone, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    n = 3000
    Xs = [torch.randn(n, 16, device=cuda, generator=gen) for _ in range(2)]
    alone = [core.vat_matrix_free(X, turbo=False) for X in Xs]
    streams = [torch.cuda.Stream() for _ in range(2)]
    steps, records = [], []
    torch.cuda.synchronize()
    for X, stream in zip(Xs, streams):
        with torch.cuda.stream(stream):
            aux = metric_aux_cuda(X, metric="euclidean")
            i0 = _streamed_seed_pivot(X, metric="euclidean")
            mind = torch.full((n,), torch.inf, device=cuda)
            sel = torch.zeros(n, dtype=torch.bool, device=cuda)
            sel[i0] = True
            order = torch.zeros(n, dtype=torch.int64, device=cuda)
            order[0] = i0
            edges = torch.zeros(n, device=cuda)
            steps.append(StreamRecord(X, aux, mind, sel, order, edges))
            records.append((order, edges))
    for t in range(1, n):
        for step in steps:
            step(t)
    torch.cuda.synchronize()
    for (order, edges), want in zip(records, alone):
        assert torch.equal(order, want.order)
        assert torch.equal(edges, want.edges)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,form", METRIC_FORMS)
def test_cuda_record_batch_lanes_equal_solo(cuda, metric, form):
    """A batched recording traversal (one launch a step for every lane,
    each lane its own ticket) gives each lane its solo traversal's order
    and edges bit for bit; one launch a step."""
    b, n = 3, 1000
    X = torch.randn(b, n, 7, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(b))
    _build.reset_launch_counts()
    got = core.vat_matrix_free_batch(X, metric=metric, form=form,
                                     turbo=False)
    counts = _build.launch_counts()
    assert counts["prim_stream_step_batch"] == n - 1
    assert counts["prim_stream_step"] == 0
    for z in range(b):
        solo = core.vat_matrix_free(X[z], metric=metric, form=form,
                                    turbo=False)
        assert torch.equal(got.order[z], solo.order)
        assert torch.equal(got.edges[z], solo.edges)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_record_loop_equals_persist_and_vat_at_4096(cuda, metric):
    """The recording loop at n = 4,096 == prim_persist == the materialized
    vat_order, order and edges bit for bit, the edges the matrix's frontier
    minima."""
    X = torch.randn(4_096, 32, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    R = ops.pairwise_dist(X, metric=metric)
    want = vat_order(R)
    stepw = core.vat_matrix_free(X, metric=metric, turbo=False)
    turbo = core.vat_matrix_free(X, metric=metric)
    assert torch.equal(stepw.order, want) and torch.equal(turbo.order, want)
    assert torch.equal(stepw.edges, turbo.edges)
    assert torch.equal(stepw.edges[1:], _frontier_minima(R, want))


@pytest.mark.cuda
def test_cuda_read_floor_reads_without_writing(cuda):
    """The read-floor entry runs over aligned and unaligned bases and
    writes nothing for ordinary data."""
    lib = _build.library()
    x = torch.randn(1_000_003, device=cuda)
    out = torch.zeros(264, dtype=torch.int32, device=cuda)
    for base in (x, x[1:]):
        err = lib.repro_read_floor(base.data_ptr(), base.numel(), 264,
                                   out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(err, "read_floor")
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(out)) == 0


# ------------------------------------------------- the sharded engine ----

@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_prim_frontier_step_against_plain(cuda, metric, form):
    """The frontier kernel against ``ref.prim_frontier_round_ref`` on the
    same tensors, six kinds, one CTA and several, vector and scalar rows:
    the least-key slot of three is the pivot and is recorded exactly; its
    lane is closed; +inf lanes stay +inf (in band); the other lanes fold
    within the pairwise tolerance; and the new slot is the kernel's own
    first-index minimum with its global id (offset honoured), its raw
    value, aux entry and point, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    offset = 70_000
    for n, d in ((200, 64), (1000, 7), (1000, 64)):
        X = torch.randn(n, d, device=cuda, generator=gen)
        aux = metric_aux_cuda(X, metric=metric)
        width = ref.slot_width(d)

        def slot(v, gid, local):
            return ref.make_slot(torch.tensor(v, device=cuda),
                                 torch.tensor(gid, device=cuda),
                                 torch.tensor(v, device=cuda), aux[local],
                                 X[local], width)

        # the least key: value 2.5 ties with a later id and beats 7.0
        table = torch.stack([slot(7.0, 3, 0), slot(2.5, offset + 17, 17),
                             slot(2.5, offset + n + 9, 1)])
        u = torch.rand(n, device=cuda, generator=gen)
        mind = torch.where(u < 0.3, torch.inf, torch.where(
            u < 0.6, ref.UNSEEN, 50.0 * torch.rand(
                n, device=cuda, generator=gen)))
        order = torch.zeros(8, dtype=torch.int64, device=cuda)
        edges = torch.zeros(8, device=cuda)
        porder, pedges = order.clone(), edges.clone()
        want, pslot = ref.prim_frontier_round_ref(
            X, aux, table, mind.clone(), porder, pedges, 5, offset=offset,
            metric=metric, form=form)
        out = torch.empty(width, device=cuda)
        was_inf = torch.isinf(mind)
        got = prim_frontier_step_cuda(X, aux, table, mind, out, order, edges,
                                      5, offset=offset, metric=metric,
                                      form=form)
        assert torch.equal(order, porder) and torch.equal(edges, pedges)
        assert int(order[5]) == offset + 17 and float(edges[5]) == 2.5
        assert torch.isinf(got[17]) and torch.all(torch.isinf(got[was_inf]))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = ~torch.isinf(got)
        tol = _tolerance(metric, form, X, None, want[fin])
        assert float(torch.amax(torch.abs(got[fin] - want[fin]))) <= tol
        i = int(torch.argmin(got))
        assert int(ref.slot_id(out)) == offset + i
        assert torch.equal(out[:2].view(torch.int64), ref.signed_key(
            got[i], torch.tensor(offset + i, device=cuda)).view(1))
        assert torch.equal(out[2:4], torch.stack([got[i], aux[i]]))
        assert torch.equal(out[4:4 + d], X[i])
        assert torch.all(out[4 + d:] == 0)
        assert torch.equal(out[2:], pslot[2:]) or not torch.equal(got, want)


@pytest.fixture(scope="module")
def nccl1(tmp_path_factory):
    """An NCCL process group of one rank (the current card) for the
    module; destroyed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield torch.device("cuda", torch.cuda.current_device())
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 257, 1000])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_cuda_sharded_one_rank_equals_both_engines(nccl1, metric, n):
    """The sharded engine over NCCL at one rank == the persistent kernel
    and the stepwise engine, order and edges bit for bit; it launches the
    frontier kernel once a vertex."""
    X = torch.randn(n, 3 + n % 5, device=nccl1,
                    generator=torch.Generator(device=nccl1).manual_seed(n))
    turbo = core.vat_matrix_free(X, metric=metric)
    stepw = core.vat_matrix_free(X, metric=metric, turbo=False)
    _build.reset_launch_counts()
    sh = core.vat_matrix_free_sharded(X, metric=metric)
    assert _build.launch_counts()["prim_frontier_step"] == n
    for res in (turbo, stepw):
        assert torch.equal(sh.order, res.order)
        assert torch.equal(sh.edges, res.edges)


def _nccl_world_main(rank, world, store):
    """One rank of the multi-card check: its own card, the same points on
    every rank; the sharded engine == the solo engines on that card, and
    the auto fit shards from n = 4,096."""
    import datetime
    from repro_torch import FastVAT
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        rng = np.random.default_rng(3)
        for metric in ref.METRICS:
            for n in (1000, 4099):
                X = torch.from_numpy(rng.normal(size=(n, 8)).astype(
                    np.float32)).to(dev)
                sh = core.vat_matrix_free_sharded(X, metric=metric)
                for turbo in (True, False):
                    solo = core.vat_matrix_free(X, metric=metric,
                                                turbo=turbo)
                    assert torch.equal(sh.order, solo.order), (metric, n)
                    assert torch.equal(sh.edges, solo.edges), (metric, n)
        rng = np.random.default_rng(5)      # centred: the gram plan
        X = np.concatenate([rng.normal(size=(2_048, 8)) + c
                            for c in (0.0, 6.0)]).astype(np.float32)
        _build.reset_launch_counts()
        fv = FastVAT(device=dev).fit(X)
        assert _build.launch_counts()["prim_frontier_step"] == 4_096
        assert _build.launch_counts()["prim_persist"] == 0
        assert fv.result.meta.numerics.form == "gram"
        np.testing.assert_array_equal(
            fv.order(), FastVAT(device=dev, turbo=True).fit(X).order())
        dist.barrier()
        if rank == 0:
            print(f"NCCL_WORLD_OK {world}", flush=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_sharded_over_every_card(cuda, tmp_path):
    """An NCCL world over every visible card (two or more): each rank's
    order and edges == the solo engines' on its card, bit for bit, since
    every rank reads the same ``dissim.cuh`` bits; the auto fit shards."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA GPUs")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(cards),
         str(tmp_path / "store")], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the NCCL world outlived 400 s: {err[-2000:]}")
    assert f"NCCL_WORLD_OK {cards}" in out, err[-3000:]


# ------------------------------------- bigvat, streaming, faults, eval ----

@pytest.mark.cuda
@pytest.mark.parametrize("block", [1_000, 4_096, 50_001])
def test_cuda_bigvat_block_loop_equals_one_call(cuda, block):
    """The assignment pass, block by block, gives the (argmin, min) of one
    (n, s) ``pairwise_dist`` call bit for bit (the kernel computes each
    entry from its own row and column), and the fit launches the pairwise
    kernel once a block plus once for the sample."""
    from repro_torch.data.synth import make_big_blobs
    X = torch.from_numpy(make_big_blobs(50_001)[0]).to(cuda)
    _build.reset_launch_counts()
    res = core.bigvat_from(X, 17, s=256, block=block)
    counts = _build.launch_counts()
    assert counts["pairwise_dist"] == -(-50_001 // block) + 1
    assert counts["vat_prim_order"] == 1 and counts["ivat_from_vat"] == 1
    P = X.index_select(0, res.sample.sample_idx)
    D = ops.pairwise_dist(X, P)
    mind, lab = torch.min(D, dim=1)
    assert torch.equal(res.labels, lab)
    assert torch.equal(res.proto_dist, mind)
    assert torch.equal(torch.sort(res.order).values,
                       torch.arange(50_001, device=cuda))
    assert int(res.group_sizes.sum()) == 50_001


@pytest.mark.cuda
def test_cuda_bigvat_memmap_equals_tensor(cuda, tmp_path):
    from repro_torch import FastVAT
    from repro_torch.data.synth import make_big_blobs
    X = make_big_blobs(30_000)[0]
    mm = np.memmap(tmp_path / "X.f32", dtype=np.float32, mode="w+",
                   shape=X.shape)
    mm[:] = X
    mm.flush()
    a = FastVAT(method="bigvat").fit(mm).result
    b = FastVAT(method="bigvat").fit(X).result
    assert a.order.is_cuda
    for f in ("order", "extension_labels", "group_sizes", "sample_idx"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
def test_cuda_streaming_order_equals_vat(cuda):
    """StreamingVAT on the card: the reservoir is the CPU stream's (host
    numpy), and ``order()`` is ``core.vat`` of it on the card, bit for
    bit."""
    from repro_torch.core.streaming import StreamingVAT
    rng = np.random.default_rng(0)
    sv = StreamingVAT(cap=256, d=8)
    host = StreamingVAT(cap=256, d=8, device="cpu")
    for c in range(4):
        chunk = rng.normal(size=(200, 8)) + 10.0 * c
        sv.update(chunk)
        host.update(chunk)
    np.testing.assert_array_equal(sv.pts, host.pts)
    want = core.vat(torch.from_numpy(sv.pts).to(cuda)).order
    np.testing.assert_array_equal(sv.order(), want.cpu().numpy())
    h, score, k = sv.tendency()
    assert 0.0 < h < 1.0 and k >= 2


@pytest.mark.cuda
def test_cuda_dispatch_fault_site(cuda):
    """An armed ``kernels.dispatch`` raises from the wrapper on the card,
    with ``use_pallas`` True; disarmed, the same call runs."""
    from repro_torch import faults
    X = torch.randn(64, 8, device=cuda)
    seen = []
    faults.disarm_all()
    try:
        faults.arm("kernels.dispatch",
                   match=lambda ctx: seen.append(dict(ctx)) or True)
        with pytest.raises(faults.FaultInjected):
            ops.pairwise_dist(X)
    finally:
        faults.disarm_all()
    assert seen == [{"op": "pairwise_dist", "use_pallas": True,
                     "device": str(X.device)}]
    assert ops.pairwise_dist(X).shape == (64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blobs", "moons", "circles", "gmm"])
def test_cuda_kmeans_dbscan_agree_with_cpu(cuda, name):
    from repro_torch.data.synth import make_dataset
    eps = {"blobs": 0.8, "moons": 0.12, "circles": 0.12, "gmm": 0.45}
    X, _ = make_dataset(name)
    Xc, Xh = torch.from_numpy(X).to(cuda), torch.from_numpy(X)
    k = 2 if name in ("moons", "circles") else 3
    km_c = core.kmeans_from(Xc, 5, k=k)[0]
    km_h = core.kmeans_from(Xh, 5, k=k)[0]
    assert core.adjusted_rand_index(km_c, km_h) >= 0.99
    db_c = core.dbscan(Xc, eps=eps[name])
    db_h = core.dbscan(Xh, eps=eps[name])
    assert db_c.is_cuda
    assert core.adjusted_rand_index(db_c, db_h) >= 0.99


@pytest.mark.cuda
def test_cuda_eval_products_ignore_a_global_tf32(cuda):
    """k-means centres, t-SNE steps and PCA on the card are the same bits
    with TF32 switched on for the process as with it off: their products
    run in full f32."""
    from repro_torch.data.synth import make_dataset
    X = torch.from_numpy(make_dataset("gmm")[0]).to(cuda)
    Y0 = 1e-2 * torch.randn((X.shape[0], 2), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(0))

    def run():
        _, centres, inertia = core.kmeans_from(X, 5, k=3)
        return (centres, inertia, core.tsne_from(X, Y0, iters=20),
                core.pca(X, k=2))

    m = torch.backends.cuda.matmul
    attr, on, off = (("fp32_precision", "tf32", "ieee")
                     if hasattr(m, "fp32_precision")
                     else ("allow_tf32", True, False))
    saved = getattr(m, attr)
    try:
        setattr(m, attr, off)
        want = run()
        setattr(m, attr, on)
        got = run()
    finally:
        setattr(m, attr, saved)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------- serving layer ----

SERVE_FIELDS = ("order", "rstar", "ivat_image", "sample_idx",
                "extension_labels", "group_sizes")


def _serve_blobs(n, d, seed, repeats=0):
    """Four Gaussian blobs; ``repeats`` rows copied from earlier rows, so
    real duplicates (zero-weight Prim edges) sit beside the padding."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(4, d))
    X = centers[np.arange(n) % 4] + rng.normal(size=(n, d))
    if repeats:
        X[n - repeats:] = X[rng.integers(0, n - repeats, size=repeats)]
    return X.astype(np.float32)


def _served_same(a, b):
    return [f for f in SERVE_FIELDS
            if (getattr(a, f) is None) != (getattr(b, f) is None)
            or (getattr(a, f) is not None
                and not torch.equal(getattr(a, f), getattr(b, f)))]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ref.METRICS)
@pytest.mark.parametrize("n,repeats", [(63, 0), (64, 0), (65, 0), (1023, 0),
                                       (1024, 0), (1025, 0), (1025, 100),
                                       (300, 150)])
def test_cuda_served_padded_rungs_equal_solo(cuda, n, repeats, metric):
    """Served vat and ivat on the card (padded to the bucket with copies
    of row 0, restricted on the card) == the solo fit bit for bit, at
    bucket boundaries and with repeated rows; the results stay on the
    card."""
    from repro_torch import FastVAT
    from repro_torch.serve import ServeConfig, TendencyServer
    X = _serve_blobs(n, 16, seed=n + repeats, repeats=repeats)
    with TendencyServer(ServeConfig(window_s=0.001)) as srv:
        for method in ("vat", "ivat"):
            served = srv.submit(X, method=method, metric=metric).result(
                timeout=300)
            solo = FastVAT(method=method, metric=metric).fit(X).result
            assert served.order.is_cuda
            assert _served_same(served, solo) == [], (method, metric, n)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_cuda_served_flashvat_lanes_equal_solo(cuda, metric):
    """Three same-n flashvat requests ride one batched dispatch (the
    persistent kernel with a group of CTAs a lane); each lane's order,
    band image, representatives, labels and band sizes == its solo
    fit."""
    from repro_torch import FastVAT
    from repro_torch.kernels import _build
    from repro_torch.serve import ServeConfig, TendencyServer
    Xs = [_serve_blobs(3000, 32, seed=s, repeats=40 * s) for s in range(3)]
    with TendencyServer(ServeConfig(window_s=5.0, max_batch=3)) as srv:
        srv.warm(3000, 32, method="flashvat", metric=metric, batch=3)
        _build.reset_launch_counts()
        futs = [srv.submit(X, method="flashvat", metric=metric) for X in Xs]
        served = [f.result(timeout=300) for f in futs]
        counts = _build.launch_counts()
        assert srv.stats().dispatched_batches == 1
    assert counts["prim_persist"] == 1 and counts["masked_argmin"] == 0
    for X, res in zip(Xs, served):
        solo = FastVAT(method="flashvat", metric=metric).fit(X).result
        assert _served_same(res, solo) == []


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(2000, 32), (50_000, 64)])
def test_cuda_ladder_stepwise_level_launches_row_10(cuda, n, d):
    """A flashvat primary whose persistent-kernel program fails to build is
    served by the ladder's turbo=False level, up to the top of flashvat's
    window: the batched step kernel (row 10) runs once a Prim step, the
    persistent kernel does not, and the result is the solo stepwise fit's
    bits; the counters read one fallback."""
    from repro_torch import FastVAT, faults
    from repro_torch.kernels import _build
    from repro_torch.serve import (ResilienceStats, RetryPolicy, ServeConfig,
                                   TendencyServer)
    X = _serve_blobs(n, d, seed=7)
    faults.disarm_all()
    try:
        faults.arm("serve.build", times=-1,
                   match=lambda ctx: ctx["key"].turbo is not False)
        with TendencyServer(ServeConfig(
                window_s=0.001, retry=RetryPolicy(max_attempts=1))) as srv:
            _build.reset_launch_counts()
            served = srv.submit(X, method="flashvat").result(timeout=300)
            counts = _build.launch_counts()
            stats = srv.stats().resilience
    finally:
        faults.disarm_all()
    assert counts["prim_persist"] == 0
    assert counts["prim_stream_step_batch"] == len(X) - 1
    assert stats == ResilienceStats(fallbacks=1, degraded=1)
    solo = FastVAT(method="flashvat", turbo=False).fit(X).result
    assert _served_same(served, solo) == []


@pytest.mark.cuda
def test_cuda_disarmed_server_counters_read_zero(cuda):
    """Every rung served on the card with faults disarmed: results == solo
    fits and every resilience counter reads 0, so no failing kernel hides
    behind the ladder."""
    from repro_torch import FastVAT, faults
    from repro_torch.serve import ResilienceStats, ServeConfig, TendencyServer
    faults.disarm_all()
    X = _serve_blobs(1500, 32, seed=3)
    with TendencyServer(ServeConfig(window_s=0.001)) as srv:
        for method in ("vat", "ivat", "flashvat"):
            served = srv.submit(X, method=method).result(timeout=300)
            solo = FastVAT(method=method).fit(X).result
            assert _served_same(served, solo) == []
        assert srv.stats().resilience == ResilienceStats()


# ------------------------------------------- the embed rung (DeepVAT) ----

def _embed_model(name, device, **replace):
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get_config(name).replace(**replace)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, M.init_params(cfg, gen, device=device)


def _same_fit(a, b):
    ra, rb = a.result, b.result
    assert torch.equal(ra.order, rb.order)
    assert torch.equal(ra.rstar, rb.rstar)
    assert np.array_equal(a.image(use_ivat=True), b.image(use_ivat=True))
    for f in ("sample_idx", "extension_labels", "group_sizes"):
        x, y = getattr(ra, f), getattr(rb, f)
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,rung", [(512, "vat"), (1024, "flashvat")])
def test_cuda_embed_fit_equals_plain_fit(cuda, seq, rung):
    """fit_embeddings of a 2-layer full-width gemma-2b (B = 4: 2,048 and
    4,096 activation rows) == FastVAT().fit of the same activations, bit
    for bit, with the rung's kernels launched."""
    from repro_torch import FastVAT
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.monitor import encode_batch
    cfg, params = _embed_model("gemma-2b", cuda, n_layers=2)
    batch = make_batch(cfg, ShapeConfig("e", seq, 4, "prefill"))
    acts = encode_batch(params, cfg, batch)
    assert acts.device.type == "cuda" and bool(torch.isfinite(acts).all())
    _build.reset_launch_counts()
    fv = FastVAT().fit_embeddings(params, cfg, batch)
    fv.image(use_ivat=True)
    counts = _build.launch_counts()
    plain = FastVAT().fit(acts)
    assert plain.method_resolved == rung and fv.result.meta.n == 4 * seq
    assert fv.result.meta.encoder.startswith("gemma-2b@")
    _same_fit(fv, plain)
    want = (("pairwise_dist", "vat_prim_order", "ivat_from_vat")
            if rung == "vat" else
            ("pairwise_dist", "prim_persist", "ivat_from_vat"))
    assert all(counts[k] > 0 for k in want), counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma-2b", "internvl2-1b"])
def test_cuda_model_forward_matches_cpu(cuda, name):
    """A full-width 2-layer forward on the card against the CPU's on the
    same weights: hidden states, logits and taps within 1e-4 of each
    tensor's scale (f32 products, no TF32, summed in another order)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg, params = _embed_model(name, cuda, n_layers=2)
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    batch = make_batch(cfg, ShapeConfig("p", 64 + extra, 1, "prefill"))
    host = {k: v.cpu() for k, v in params.items() if k != "layers"}
    host["layers"] = {k: v.cpu() for k, v in params["layers"].items()}
    with torch.inference_mode():
        logits, _, taps = M.forward(params, cfg, batch, taps=True)
        hidden, _ = M.forward(params, cfg, batch, return_hidden=True)
        cpu_batch = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                     for k, v in batch.items()}
        want_l, _, want_t = M.forward(host, cfg, cpu_batch, taps=True)
        want_h, _ = M.forward(host, cfg, cpu_batch, return_hidden=True)
    for got, want in ((logits, want_l), (hidden, want_h),
                      (taps["layer_out"], want_t["layer_out"])):
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


# ------------------------- the moe, ssm, hybrid and audio families ----

#: Full widths at 1-2 layers (a super-block for hybrid; deepseek-v3's MLA,
#: shared expert and MTP block at full width over 16 of its 256 experts,
#: which keeps its CPU copy near 10 GB).
FAMILY_CUTS = [("phi3.5-moe-42b-a6.6b", {"n_layers": 1}),
               ("deepseek-v3-671b", {"n_layers": 1, "n_experts": 16}),
               ("rwkv6-3b", {"n_layers": 2}),
               ("zamba2-2.7b", {"n_layers": 6}),
               ("whisper-large-v3", {"n_layers": 1, "n_enc_layers": 1})]
FAMILY_IDS = ["phi35", "dsv3", "rwkv6", "zamba2", "whisper"]


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _expert_ids(cfg, logits):
    from repro_torch.models.moe import _top_k
    return _top_k(torch.softmax(logits, -1), cfg.top_k)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cut", FAMILY_CUTS, ids=FAMILY_IDS)
def test_cuda_family_forward_matches_cpu(cuda, name, cut):
    """A full-width forward on the card against the CPU's on the same
    weights: logits, hidden states, taps (and router logits, after the
    same expert ids) within 1e-4 of each tensor's scale; aux (MTP on
    deepseek-v3, with labels) within 1e-4."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg, params = _embed_model(name, cuda, **cut)
    kind = "train" if cfg.mtp else "prefill"
    batch = make_batch(cfg, ShapeConfig("p", 64, 1, kind))
    host = _tree_to(params, "cpu")
    cpu_batch = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in batch.items()}
    with torch.inference_mode():
        logits, aux, taps = M.forward(params, cfg, batch, taps=True)
        hidden, _ = M.forward(params, cfg, batch, return_hidden=True)
        want_l, want_a, want_t = M.forward(host, cfg, cpu_batch, taps=True)
        want_h, _ = M.forward(host, cfg, cpu_batch, return_hidden=True)
    pairs = [(logits, want_l), (hidden, want_h),
             (taps["layer_out"], want_t["layer_out"])]
    if cfg.family == "moe":
        assert torch.equal(_expert_ids(cfg, taps["router_logits"]).cpu(),
                           _expert_ids(cfg, want_t["router_logits"]))
        pairs.append((taps["router_logits"], want_t["router_logits"]))
        assert abs(float(aux) - float(want_a)) <= 1e-4 * abs(float(want_a))
    for got, want in pairs:
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name,cut", FAMILY_CUTS + [
    ("internvl2-1b", {"n_layers": 2})], ids=FAMILY_IDS + ["vlm"])
def test_cuda_prefill_decode_matches_forward(cuda, name, cut):
    """prefill of 32 tokens (f32 cache) then 8 decode_steps on the card
    against the forward of the same 40: within 2e-3 of its scale (5e-3
    for hybrid); moe at capacity max(16, E / K), so nothing drops."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg, params = _embed_model(name, cuda, **cut)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=max(16.0,
                                              cfg.n_experts / cfg.top_k))
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    batch = make_batch(cfg, ShapeConfig("d", 40 + extra, 1, "prefill"))
    toks = torch.as_tensor(batch["tokens"], device=cuda)
    rest = {k: v for k, v in batch.items() if k != "tokens"}
    with torch.inference_mode():
        full, _ = M.forward(params, cfg, {"tokens": toks, **rest})
        lp, cache, pos = M.prefill(params, cfg, {"tokens": toks[:, :32],
                                                 **rest}, 48 + extra,
                                   cache_dtype=torch.float32)
        assert pos == 32 + extra
        steps = []
        for i in range(8):
            lg, cache = M.decode_step(params, cfg, toks[:, 32 + i:33 + i],
                                      cache, pos + i)
            steps.append(lg)
    tol = 5e-3 if cfg.family == "hybrid" else 2e-3
    scale = float(full.abs().max())
    assert float((lp - full[:, :32]).abs().max()) <= tol * scale
    assert float((torch.cat(steps, 1) - full[:, 32:]).abs().max()) \
        <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name,cut", [
    ("phi3.5-moe-42b-a6.6b", {"n_layers": 2}),
    ("deepseek-v3-671b", {"n_layers": 1, "n_experts": 32, "mtp": False})],
    ids=["top2", "top8"])
def test_cuda_moe_forward_repeats_bit_for_bit(cuda, name, cut):
    """Two forwards of the same batch give the same bits: the dispatch
    writes by index and the combine adds a token's K contributions in
    slot order, so no atomic order reaches the result."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg, params = _embed_model(name, cuda, **cut)
    batch = make_batch(cfg, ShapeConfig("r", 256, 2, "prefill"))
    with torch.inference_mode():
        a, aux_a, ta = M.forward(params, cfg, batch, taps=True)
        b, aux_b, tb = M.forward(params, cfg, batch, taps=True)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert torch.equal(ta["router_logits"], tb["router_logits"])


@pytest.mark.cuda
def test_cuda_family_embed_fit_equals_plain_fit(cuda):
    """fit_embeddings of a 2-layer full-width rwkv6-3b (B = 4, S = 512:
    2,048 rows of d 2,560) == FastVAT().fit of the same activations, bit
    for bit, with the vat rung's kernels launched."""
    from repro_torch import FastVAT
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.monitor import encode_batch
    cfg, params = _embed_model("rwkv6-3b", cuda, n_layers=2)
    batch = make_batch(cfg, ShapeConfig("e", 512, 4, "prefill"))
    acts = encode_batch(params, cfg, batch)
    _build.reset_launch_counts()
    fv = FastVAT().fit_embeddings(params, cfg, batch)
    fv.image(use_ivat=True)
    counts = _build.launch_counts()
    plain = FastVAT().fit(acts)
    assert plain.method_resolved == "vat" and fv.result.meta.n == 2048
    assert fv.result.meta.encoder.startswith("rwkv6-3b@")
    _same_fit(fv, plain)
    assert all(counts[k] > 0 for k in ("pairwise_dist", "vat_prim_order",
                                       "ivat_from_vat")), counts


@pytest.mark.cuda
def test_cuda_fit_embeddings_refuses_cpu_params(cuda):
    from repro_torch import FastVAT, configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg = configs.smoke_config("gemma-2b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = make_batch(cfg, ShapeConfig("e", 32, 2, "prefill"))
    with pytest.raises(ValueError, match="params live on cpu"):
        FastVAT().fit_embeddings(params, cfg, batch)


# ------------------------------------------------------------ training ----

#: A mid-width dense model (products past TF32's reach: d 512) and the
#: smoke moe (its dispatch and combine in the backward).
TRAIN_CUTS = [("gemma-2b", {"n_layers": 2, "d_model": 512, "n_heads": 4,
                            "head_dim": 128, "d_ff": 1024, "vocab": 4096}),
              ("phi3.5-moe-42b-a6.6b", {"n_layers": 2, "d_model": 256,
                                        "n_heads": 4, "n_kv_heads": 4,
                                        "head_dim": 64, "d_ff": 512,
                                        "d_ff_expert": 256,
                                        "n_experts": 8, "top_k": 2,
                                        "vocab": 2048})]
TRAIN_IDS = ["gemma", "moe"]


def _train_model(name, cut, device, seq=128, B=2, **replace):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg = configs.get_config(name).replace(**cut, **replace)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    batch = make_batch(cfg, ShapeConfig("t", seq, B, "train"), device=device)
    return cfg, params, batch


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def _clone(tree):
    from repro_torch.optim.adamw import tree_map
    return tree_map(torch.clone, tree)


def _ratio(got, want) -> float:
    worst = 0.0
    for a, b in zip(_leaves(got), _leaves(want)):
        b = b.float().cpu()
        scale = float(b.abs().max()) or 1.0
        worst = max(worst, float((a.float().cpu() - b).abs().max()) / scale)
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("name,cut", TRAIN_CUTS, ids=TRAIN_IDS)
def test_cuda_train_step_matches_cpu(cuda, name, cut):
    """The card's loss and gradient against the CPU's on the same weights,
    each leaf within 1e-4 of its scale; a train step's loss and gradient
    norm too, and its in-place route equal bit for bit to the copying
    one."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw as O
    from repro_torch.train import steps as S
    cfg, params, batch = _train_model(name, cut, cuda)
    host = _tree_to(params, "cpu")
    host_batch = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in batch.items()}
    m, g = S.value_and_grad(params, cfg, batch)
    mh, gh = S.value_and_grad(host, cfg, host_batch)
    assert abs(float(m["loss"]) - float(mh["loss"])) \
        <= 1e-4 * abs(float(mh["loss"]))
    assert _ratio(g, gh) <= 1e-4
    tc = TrainConfig(warmup_steps=1)
    state = S.TrainState(params, O.init_opt(tc, params), None)
    new, metrics = S.build_train_step(cfg, tc)(state, batch)
    _, hm = S.build_train_step(cfg, tc)(
        S.TrainState(host, O.init_opt(tc, host), None), host_batch)
    assert abs(float(metrics["grad_norm"]) - float(hm["grad_norm"])) \
        <= 1e-4 * float(hm["grad_norm"])
    donated = S.TrainState(_clone(params), O.init_opt(tc, params), None)
    again, m2 = S.build_train_step(cfg, tc, donate=True)(donated, batch)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(new.params),
                                                 _leaves(again.params)))
    assert float(m2["loss"]) == float(metrics["loss"])


@pytest.mark.cuda
def test_cuda_gradient_is_full_f32_under_process_tf32(cuda):
    """With TF32 switched on for the whole process, the gradient (forward,
    backward and the rematerialized forward) is still the full-f32 one,
    bit for bit; the same products outside the step do use TF32 there."""
    from repro_torch.train import steps as S
    name, cut = TRAIN_CUTS[0]
    cfg, params, batch = _train_model(name, cut, cuda)
    m = torch.backends.cuda.matmul
    attr, on, off = (("fp32_precision", "tf32", "ieee")
                     if hasattr(m, "fp32_precision")
                     else ("allow_tf32", True, False))
    saved = getattr(m, attr)
    try:
        setattr(m, attr, off)
        _, want = S.value_and_grad(params, cfg, batch)
        x = params["layers"]["w_up"][0]
        exact = x.T @ x
        setattr(m, attr, on)
        assert not torch.equal(x.T @ x, exact)     # TF32 is really on
        _, got = S.value_and_grad(params, cfg, batch)
    finally:
        setattr(m, attr, saved)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                 _leaves(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("name,cut", TRAIN_CUTS, ids=TRAIN_IDS)
def test_cuda_repeated_steps_bit_for_bit(cuda, name, cut):
    """The deterministic route: the embedding's backward (``F.embedding``)
    and the moe dispatch's (a repeat, summed in order) add in a fixed
    order, so two runs of the same steps give the same bits."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw as O
    from repro_torch.train import steps as S
    cfg, params, batch = _train_model(name, cut, cuda)
    tc = TrainConfig(warmup_steps=1)
    runs = []
    for _ in range(2):
        p = _clone(params)
        state = S.TrainState(p, O.init_opt(tc, p), None)
        step = S.build_train_step(cfg, tc, donate=True)
        losses = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs.append((losses, state))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(_leaves(runs[0][1].params),
                                                 _leaves(runs[1][1].params)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "dots"])
@pytest.mark.parametrize("name,cut", TRAIN_CUTS, ids=TRAIN_IDS)
def test_cuda_remat_modes_give_equal_gradients(cuda, name, cut, mode):
    """``remat`` "full" and "dots" recompute the forward in the backward:
    the gradient equals "none"'s within f32 tolerance (1e-5 of scale)."""
    from repro_torch.train import steps as S
    cfg, params, batch = _train_model(name, cut, cuda, remat="none")
    _, want = S.value_and_grad(params, cfg, batch)
    _, got = S.value_and_grad(params, cfg.replace(remat=mode), batch)
    assert _ratio(got, want) <= 1e-5


@pytest.mark.cuda
def test_cuda_observe_launches_rows_1_and_3prime(cuda):
    """A diag step on the card: each default probe launches row 1 three
    times (its sample, Hopkins's two blocks) and row 3' once; the
    summaries lie in [0, 1] and repeat bit for bit in (seed, step)."""
    from repro_torch.kernels import _build
    from repro_torch.monitor import TendencyMonitor
    name, cut = TRAIN_CUTS[0]
    cfg, params, batch = _train_model(name, cut, cuda)
    mon = TendencyMonitor(cfg, seed=5, device=cuda)
    _build.reset_launch_counts()
    summ = mon.observe(2, params, batch)
    counts = _build.launch_counts()
    assert counts["pairwise_dist"] == 3 * len(mon.specs)
    assert counts["vat_prim_order"] == len(mon.specs)
    for s in summ.values():
        assert 0 <= s["hopkins"] <= 1 and 0 <= s["block_score"] <= 1
    again = TendencyMonitor(cfg, seed=5, device=cuda).observe(2, params,
                                                              batch)
    assert again == summ


@pytest.mark.cuda
def test_cuda_train_loop_resumes_bit_for_bit(cuda, tmp_path):
    """``train()`` on the card, interrupted after step 3 and resumed from
    the step-2 checkpoint, ends with the uninterrupted run's params and
    history."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.monitor import AUX_NAME
    from repro_torch.train.loop import train
    cfg = configs.smoke_config("phi3.5-moe-42b-a6.6b")
    shape = ShapeConfig("t", 128, 4, "train")
    states, hists = [], []
    for run in ("a", "b"):
        tc = TrainConfig(total_steps=5, ckpt_every=2, diag_every=2,
                         ckpt_dir=str(tmp_path / run))
        if run == "b":
            with pytest.raises(KeyboardInterrupt):
                train(cfg, tc, shape, log=lambda s: None, interrupt_at=3)
        state, _ = train(cfg, tc, shape, log=lambda s: None)
        states.append(dict(ckpt._walk(state)))
        hists.append(ckpt.load_aux(tc.ckpt_dir, AUX_NAME))
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    assert all(np.array_equal(hists[0][k], hists[1][k]) for k in hists[0])


if __name__ == "__main__":
    import torch.multiprocessing as mp
    _world = int(sys.argv[1])
    mp.spawn(_nccl_world_main, args=(_world, sys.argv[2]), nprocs=_world)

"""The port's kernels (repro_torch.kernels) held against the JAX package's.

On the CPU the port's ops take the plain PyTorch versions (``ref.py``);
the JAX side runs its Pallas kernels in interpret mode
(``repro.kernels.ops.*(use_pallas=True)``) and its own refs.  Inputs are
made with numpy from a seed and handed to both.  The CUDA kernels
themselves run only on a GPU: ``test_torch_cuda.py`` holds them against
the plain versions there.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ivat_update import ivat_from_vat_cuda
from repro_torch.kernels.knn_graph import (knn_topk_cuda,
                                          knn_topk_segmented_cuda)
from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
from repro_torch.kernels.prim_update import (masked_argmin_cuda,
                                             vat_prim_order_cuda)
from repro_torch.numerics.condition import _quantize_bf16

F32_EPS = float(np.finfo(np.float32).eps)
FORMS = ("gram", "direct")


def _tolerance(metric, form, X, Y, want):
    """Section-7 tolerances: a sqrt of the Gram cancellation floor for
    gram-form euclidean, 1e-5 of the matrix scale (+1e-6) otherwise."""
    if metric == "euclidean" and form == "gram":
        sq = max(float(np.max(np.sum(np.float64(A) ** 2, axis=1)))
                 for A in (X, X if Y is None else Y))
        return (16 * F32_EPS * sq) ** 0.5
    return 1e-5 * float(np.max(np.abs(want))) + 1e-6


def _port_pairwise(X, Y, metric, form):
    Yt = None if Y is None else torch.from_numpy(Y)
    return ops.pairwise_dist(torch.from_numpy(X), Yt, metric=metric,
                             form=form).numpy()


def _jax_pairwise(X, Y, metric, form, use_pallas):
    Yj = None if Y is None else jnp.asarray(Y)
    return np.asarray(jops.pairwise_dist(jnp.asarray(X), Yj, metric=metric,
                                         form=form, use_pallas=use_pallas))


@pytest.mark.parametrize("n,m,d", [(67, None, 5), (100, 37, 10),
                                   (130, 70, 130), (129, None, 3),
                                   (257, 131, 33), (2, None, 1)])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ref.METRICS)
def test_pairwise_matches_reference(metric, form, n, m, d):
    rng = np.random.default_rng(n * 1000 + d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = None if m is None else rng.normal(size=(m, d)).astype(np.float32)
    got = _port_pairwise(X, Y, metric, form)
    assert got.dtype == np.float32 and got.shape == (n, n if m is None else m)
    for use_pallas in (True, False):
        want = _jax_pairwise(X, Y, metric, form, use_pallas)
        tol = _tolerance(metric, form, X, Y, want)
        assert np.max(np.abs(got - want)) <= tol, (use_pallas, tol)
    if Y is None:
        assert not np.diag(got).any()   # the exact zero diagonal


@pytest.mark.parametrize("metric", ref.METRICS)
def test_pairwise_bf16_storage(metric):
    """bf16-quantized points: the port's bfloat16 tensor, its f32 copy
    and the JAX kernel on the quantized values agree."""
    rng = np.random.default_rng(7)
    X = _quantize_bf16(rng.normal(size=(90, 17)).astype(np.float32))
    Y = _quantize_bf16(rng.normal(size=(33, 17)).astype(np.float32))
    as_bf16 = ops.pairwise_dist(torch.from_numpy(X).bfloat16(),
                                torch.from_numpy(Y).bfloat16(),
                                metric=metric).numpy()
    np.testing.assert_array_equal(as_bf16,
                                  _port_pairwise(X, Y, metric, "gram"))
    want = _jax_pairwise(X, Y, metric, "gram", use_pallas=True)
    assert np.max(np.abs(as_bf16 - want)) <= _tolerance(metric, "gram", X, Y,
                                                        want)


def _argmin_cases(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-5, 6, size=n).astype(np.float32)   # many ties
    all_but_one = np.ones(n, bool)
    all_but_one[n // 3] = False
    return vals, {"random": rng.random(n) < 0.5, "none": np.zeros(n, bool),
                  "all_but_one": all_but_one, "all": np.ones(n, bool)}


@pytest.mark.parametrize("n", [1, 17, 1000, 2049])
def test_masked_argmin_bitwise(n):
    vals, masks = _argmin_cases(n, seed=n)
    for name, mask in masks.items():
        pv, pi = ops.masked_argmin(torch.from_numpy(vals),
                                   torch.from_numpy(mask))
        assert pv.dtype == torch.float32 and pi.dtype == torch.int64
        for use_pallas, block in ((True, 8), (True, 1024), (False, 1024)):
            jv, ji = jops.masked_argmin(jnp.asarray(vals), jnp.asarray(mask),
                                        use_pallas=use_pallas, block=block)
            assert int(pi) == int(ji), (name, use_pallas, block)
            assert np.float32(pv).tobytes() == np.float32(jv).tobytes()
    assert float(ops.masked_argmin(torch.from_numpy(vals),
                                   torch.from_numpy(masks["all"]))[0]) \
        == np.inf


def _vat_ordered(n, seed, d=4):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n // 2, d)),
                        rng.normal(size=(n - n // 2, d)) + 5.0])
    from repro.core.vat import vat
    return np.array(vat(jnp.asarray(X, jnp.float32)).rstar)


@pytest.mark.parametrize("n", [1, 2, 65, 256])
def test_ivat_bitwise(n):
    rstar = _vat_ordered(n, seed=n) if n > 1 else np.zeros((1, 1), np.float32)
    got = ops.ivat_from_vat(torch.from_numpy(rstar)).numpy()
    for use_pallas in (True, False):
        want = np.asarray(jops.ivat_from_vat(jnp.asarray(rstar),
                                             use_pallas=use_pallas))
        np.testing.assert_array_equal(got, want)


def test_ivat_batch_matches_solo():
    stack = np.stack([_vat_ordered(40, seed=s) for s in range(3)])
    got = ops.ivat_from_vat(torch.from_numpy(stack)).numpy()
    want = np.asarray(jops.ivat_from_vat(jnp.asarray(stack), use_pallas=True))
    np.testing.assert_array_equal(got, want)


def test_ref_versions_match_jax_refs():
    """The plain versions are the JAX refs written in PyTorch."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 6)).astype(np.float32)
    for metric in ref.METRICS:
        for form in FORMS:
            got = ref.pairwise_dissim_ref(torch.from_numpy(X), metric=metric,
                                          form=form).numpy()
            want = np.asarray(jref.pairwise_dissim_ref(
                jnp.asarray(X), metric=metric, form=form))
            assert np.max(np.abs(got - want)) <= _tolerance(
                metric, form, X, None, want)
    with pytest.raises(ValueError, match="metric must be one of"):
        ref.check_metric("hamming")


def test_cpu_dispatch_launches_no_kernel():
    _build.reset_launch_counts()
    X = torch.randn(20, 3)
    R = ops.pairwise_dist(X)
    ops.masked_argmin(R[0], torch.zeros(20, dtype=torch.bool))
    ops.ivat_from_vat(R)
    ops.vat_prim_order(R, torch.tensor([0]))
    ops.knn_graph(X, k=3)
    ids = torch.arange(20)
    ops.knn_topk_segmented(X, X, ids, ids, torch.tensor([0, 20]),
                           torch.tensor([0, 20]), k=3)
    assert _build.launch_counts() == {"pairwise_dist": 0,
                                      "masked_argmin": 0,
                                      "ivat_from_vat": 0,
                                      "prim_persist": 0,
                                      "prim_stream_step": 0,
                                      "knn_graph": 0,
                                      "pairwise_dist_batch": 0,
                                      "prim_stream_step_batch": 0,
                                      "knn_graph_batch": 0,
                                      "prim_frontier_step": 0,
                                      "vat_prim_order": 0,
                                      "knn_graph_segmented": 0}


@pytest.mark.parametrize("call", [
    lambda: pairwise_dist_cuda(torch.zeros(4, 2)),
    lambda: masked_argmin_cuda(torch.zeros(4), torch.zeros(4, dtype=bool)),
    lambda: ivat_from_vat_cuda(torch.zeros(4, 4)),
    lambda: knn_topk_cuda(torch.zeros(4, 2), torch.zeros(4, 2),
                          torch.arange(4), torch.arange(4), k=2),
    lambda: vat_prim_order_cuda(torch.zeros(4, 4), torch.tensor([0])),
    lambda: knn_topk_segmented_cuda(
        torch.zeros(4, 2), torch.zeros(4, 2), torch.arange(4),
        torch.arange(4), torch.tensor([0, 4]), torch.tensor([0, 4]), k=2),
], ids=["pairwise_dist", "masked_argmin", "ivat_from_vat", "knn_graph",
        "vat_prim_order", "knn_graph_segmented"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises; it never computes on the
    CPU itself."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()


def _segments(seed, d):
    """Seven segments of a segmented kNN call: an empty cell (queries, no
    candidates), a cell with no queries, cells with fewer candidates than
    15, queries that are their own candidates, padded candidates and a
    sentinel query id."""
    rng = np.random.default_rng(seed)
    sizes = [(40, 0), (0, 30), (25, 3), (50, 14), (31, 60), (9, 1), (70, 45)]
    qoff = np.concatenate([[0], np.cumsum([q for q, _ in sizes])])
    coff = np.concatenate([[0], np.cumsum([c for _, c in sizes])])
    Xc = rng.integers(-6, 7, size=(coff[-1], d)).astype(np.float32)
    cid = rng.permutation(10_000)[:coff[-1]].astype(np.int64)
    cid[::11] = -1                                  # padded candidates
    Xq = rng.integers(-6, 7, size=(qoff[-1], d)).astype(np.float32)
    qid = rng.permutation(10_000)[:qoff[-1]].astype(np.int64)
    qid[::5] = -1                                   # sentinel queries
    for g, (q, c) in enumerate(sizes):              # own-candidate queries
        for i in range(min(q, c) // 2):
            Xq[qoff[g] + i] = Xc[coff[g] + i]
            qid[qoff[g] + i] = cid[coff[g] + i]
    return [torch.from_numpy(a) for a in (Xq, Xc, qid, cid, qoff, coff)]


@pytest.mark.parametrize("k", [1, 15])
@pytest.mark.parametrize("metric", ref.METRICS)
def test_knn_topk_segmented_equals_per_segment_calls(metric, k):
    """One segmented call == ``ops.knn_topk`` segment by segment, bit for
    bit; an empty cell's rows and the slots a short cell cannot fill hold
    (+inf, -1), and no query lists itself."""
    Xq, Xc, qid, cid, qoff, coff = _segments(seed=k, d=3)
    dist, idx = ops.knn_topk_segmented(Xq, Xc, qid, cid, qoff, coff, k=k,
                                       metric=metric)
    assert dist.shape == idx.shape == (Xq.shape[0], k)
    for g in range(len(qoff) - 1):
        q0, q1, c0, c1 = (int(qoff[g]), int(qoff[g + 1]), int(coff[g]),
                          int(coff[g + 1]))
        if q1 == q0:
            continue
        if c1 == c0:
            assert bool(torch.isinf(dist[q0:q1]).all())
            assert bool((idx[q0:q1] == -1).all())
            continue
        want = ops.knn_topk(Xq[q0:q1], Xc[c0:c1], qid[q0:q1], cid[c0:c1],
                            k=k, metric=metric)
        assert torch.equal(dist[q0:q1], want[0])
        assert torch.equal(idx[q0:q1], want[1])
        valid = int((cid[c0:c1] >= 0).sum())
        assert bool((idx[q0:q1, valid:] == -1).all())
    assert not bool(((idx == qid[:, None]) & (idx >= 0)).any())


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="needs nvcc"):
        _build.find_nvcc()


def test_build_hash_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"pairwise_dist.cu", "prim_update.cu", "ivat_update.cu",
            "prim_persist.cu", "prim_stream.cu", "knn_graph.cu",
            "argmin_key.cuh", "dissim.cuh"} <= names
    assert _build.source_hash() == _build.source_hash()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    for src in _build.CSRC.glob("*.cu"):
        head = src.read_text().split("#include")[0]
        assert "Replaces: src/repro/kernels/" in head, src.name
        assert "bounds it on the H100" in head, src.name
        assert "Design:" in head, src.name


def _c_entries() -> dict:
    """name -> parameter declarations of every ``extern "C"`` definition in
    ``csrc/*.cu``."""
    entries = {}
    for src in _build.CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C"[^(;]*?\b(repro_\w+)\s*\(([^)]*)\)',
                             src.read_text()):
            params = [p.strip() for p in m.group(2).split(",")]
            entries[m.group(1)] = [p for p in params if p]
    return entries


def _ctype(param: str):
    """The ctypes type a C parameter declaration is bound with."""
    if "*" in param:
        return _build.ctypes.c_void_p
    decl = param.rsplit(None, 1)[0].replace("const ", "").strip()
    return {"int": _build.ctypes.c_int, "float": _build.ctypes.c_float,
            "long long": _build.ctypes.c_longlong}[decl]


def test_signatures_match_every_c_entry():
    """``_build.SIGNATURES`` binds every C entry of the library with its own
    argument count and types: a wrong one would pass a pointer cut to 32
    bits, or shift every argument after it, and only the card would
    show it."""
    entries = _c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, params in entries.items():
        assert [_ctype(p) for p in params] == list(_build.SIGNATURES[name]), \
            name

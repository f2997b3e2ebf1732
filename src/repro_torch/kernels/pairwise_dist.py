"""CUDA kernel: tiled pairwise dissimilarity matrix, metric-dispatched.

The port of ``repro/kernels/pairwise_dist.py::pairwise_dist_pallas`` and,
with a lane axis (``pairwise_dist_batch_cuda``), of
``pairwise_dist_pallas_batch``.  The kernel is ``csrc/pairwise_dist.cu``
(its opening note gives the design and what bounds it); this module checks
the inputs, allocates the output and the scratch (row norms, feature-major
copies of the rows), and launches on the current stream.  It has no plain
fallback: ``kernels/ops.py`` sends CPU tensors to ``ref.py`` instead.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import check_metric
from repro_torch.numerics.condition import check_form

#: (metric, form) -> the kernel's metric kind (``enum Kind`` in the .cu).
#: manhattan has only a direct form and cosine only a gram form, so the
#: form is ignored for them, as in the reference.
_KINDS = {
    ("sqeuclidean", "gram"): 0, ("euclidean", "gram"): 1,
    ("cosine", "gram"): 2, ("cosine", "direct"): 2,
    ("sqeuclidean", "direct"): 3, ("euclidean", "direct"): 4,
    ("manhattan", "gram"): 5, ("manhattan", "direct"): 5,
}

_DTYPES = (torch.float32, torch.bfloat16)


def check_cuda(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` is a contiguous tensor on the current CUDA device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} lies on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=256)
def _scratch_words(b: int, n: int, m: int, d: int, y_is_x: bool) -> int:
    """f32 words of a call's scratch, as the library lays it out (cached:
    one C call fewer a launch on the repeated shapes of a path)."""
    return _build.library().repro_pairwise_scratch_words(b, n, m, d,
                                                         int(y_is_x))


def _scratch(b: int, n: int, m: int, d: int, y_is_x: bool,
             device) -> torch.Tensor:
    """The kernel's f32 scratch (row norms, feature-major copies of the
    rows).  Freed on return while the kernel may still run: the caching
    allocator hands it out again only to later work on this stream, which
    runs after the kernel."""
    return torch.empty(_scratch_words(b, n, m, d, y_is_x),
                       dtype=torch.float32, device=device)


def pairwise_dist_cuda(X: torch.Tensor, Y: torch.Tensor | None = None, *,
                       metric: str = "euclidean", form: str = "gram",
                       zero_diag: bool = False) -> torch.Tensor:
    """(n, m) f32 dissimilarity matrix of X (n, d) against Y (m, d).

    Args:
      X: (n, d) contiguous CUDA tensor, float32 or bfloat16 (storage only:
        the kernel accumulates in f32).
      Y: (m, d) like X, same dtype, or None for Y = X (the kernel then
        computes one triangle of tiles and mirrors it, so R[i, j] ==
        R[j, i] bit for bit).
      metric: one of ``ref.METRICS``.
      form: "gram" or "direct" (euclidean / sqeuclidean only).
      zero_diag: with Y None, write the diagonal as exactly 0 in the
        kernel's epilogue (``ops.pairwise_dist`` asks for it); by default
        the diagonal is the kernel's own value.

    Returns:
      (n, m) float32 matrix.
    """
    check_metric(metric)
    check_form(form)
    check_cuda(X, "X")
    y_is_x = Y is None
    if y_is_x:
        Y = X
    else:
        check_cuda(Y, "Y")
        if zero_diag:
            raise ValueError("zero_diag needs Y=None (a self-matrix)")
    if X.dtype not in _DTYPES or Y.dtype != X.dtype:
        raise ValueError(f"X and Y must share a dtype in {_DTYPES}, got "
                         f"{X.dtype} and {Y.dtype}")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"want X (n, d) and Y (m, d), got {tuple(X.shape)} "
                         f"and {tuple(Y.shape)}")
    n, d = X.shape
    m = Y.shape[0]
    if n == 0 or m == 0 or d == 0:
        raise ValueError(f"empty input: X {tuple(X.shape)}, Y {tuple(Y.shape)}")
    out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    scratch = _scratch(1, n, m, d, y_is_x, X.device)
    err = _build.library().repro_pairwise_dist(
        X.data_ptr(), Y.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, m,
        d, _KINDS[(metric, form)], int(X.dtype == torch.bfloat16),
        int(y_is_x), int(zero_diag), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pairwise_dist")
    _build.LAUNCHES["pairwise_dist"] += 1
    return out


def check_lanes(b: int) -> None:
    """Raise unless 1 <= b <= ``MAX_LANES`` (the batch is a grid axis)."""
    if not 1 <= b <= _build.MAX_LANES:
        raise ValueError(f"a batched launch takes 1 to {_build.MAX_LANES} "
                         f"lanes, got b={b}")


def pairwise_dist_batch_cuda(X: torch.Tensor, *, metric: str = "euclidean",
                             form: str = "gram") -> torch.Tensor:
    """(b, n, n) f32 self-dissimilarity matrices of a (b, n, d) stack.

    One launch (and one pre-pass over all b·n rows): lane z of the grid
    computes X[z]'s matrix with the tile code of ``pairwise_dist_cuda``, so
    lane z equals ``pairwise_dist_cuda(X[z], zero_diag=True)`` bit for bit;
    the diagonal is written as exactly 0.

    Args:
      X: (b, n, d) contiguous CUDA tensor, float32 or bfloat16, with
        1 <= b <= ``MAX_LANES``.
      metric: one of ``ref.METRICS``.
      form: "gram" or "direct".

    Returns:
      (b, n, n) float32 stack with exactly-zero diagonals.
    """
    check_metric(metric)
    check_form(form)
    check_cuda(X, "X")
    if X.dtype not in _DTYPES or X.dim() != 3 or 0 in X.shape[1:]:
        raise ValueError(f"want a (b, n, d) float32 or bfloat16 stack with "
                         f"n, d >= 1, got {X.dtype} {tuple(X.shape)}")
    b, n, d = X.shape
    check_lanes(b)
    out = torch.empty((b, n, n), dtype=torch.float32, device=X.device)
    scratch = _scratch(b, n, n, d, True, X.device)
    err = _build.library().repro_pairwise_dist_batch(
        X.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n, d,
        _KINDS[(metric, form)], int(X.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pairwise_dist_batch")
    _build.LAUNCHES["pairwise_dist_batch"] += 1
    return out


def metric_aux_cuda(X: torch.Tensor, *, metric: str) -> torch.Tensor:
    """(n,) f32 aux vector of X for the Prim kernels, on the card ((b, n)
    for a (b, n, d) stack: row-wise, so each lane's are its own bits).

    Squared row norms for euclidean/sqeuclidean, norms for cosine, zeros
    for manhattan — the values ``kernels.ref.metric_aux_ref`` gives, but
    computed by the row-norm pre-pass of ``csrc/pairwise_dist.cu``, the
    very norms the gram and cosine tiles use.  That is what makes a
    matrix-free Prim row equal the materialized matrix's row bit for bit.
    It is that kernel's pre-pass and counts no launch of its own.
    """
    check_metric(metric)
    check_cuda(X, "X")
    if X.dtype not in _DTYPES or X.dim() not in (2, 3) or 0 in X.shape:
        raise ValueError(f"want a non-empty (n, d) or (b, n, d) float32 or "
                         f"bfloat16 X, got {X.dtype} {tuple(X.shape)}")
    d = X.shape[-1]
    n = X.numel() // d    # a stack's rows, one pre-pass over all of them
    if metric == "manhattan":
        return torch.zeros(X.shape[:-1], dtype=torch.float32,
                           device=X.device)
    out = torch.empty(X.shape[:-1], dtype=torch.float32, device=X.device)
    err = _build.library().repro_metric_aux(
        X.data_ptr(), n, d, int(metric == "cosine"),
        int(X.dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "metric_aux")
    return out

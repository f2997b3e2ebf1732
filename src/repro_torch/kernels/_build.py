"""Build and load the port's CUDA kernels: ``nvcc`` into one ``.so``, bound
with ``ctypes``.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` (Hopper) into an
object file, all sources at once in parallel, and the objects are linked
into one shared library with a plain C interface.  The library goes to
``build/repro_torch/`` at the repository root (a generated directory that
git ignores), named by a hash of the sources and flags, so an edited source
builds a new library and an unchanged one is reused.  Nothing here runs at
import: the first kernel launch calls ``library()``, which builds if needed
and raises ``RuntimeError`` when no ``nvcc`` is found.

The launch counts of the kernels live here too, one plain integer per
kernel: each wrapper adds one where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The C interface of the library: function name -> argument types.  The
#: launch functions return the ``cudaError_t`` of their launches as an int.
SIGNATURES = {
    # X, Y, scratch, out, n, m, d, kind, is_bf16, y_is_x, zero_diag, stream
    "repro_pairwise_dist": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # X, scratch, out, b, n, d, kind, is_bf16, stream
    "repro_pairwise_dist_batch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # b, n, m, d, y_is_x: 4-byte words of a call's scratch (long long)
    "repro_pairwise_scratch_words": (_I, _I, _I, _I, _I),
    # vals, mask, b, n, partial, out, stream
    "repro_masked_argmin": (_P, _P, _I, _I, _P, _P, _P),
    "repro_masked_argmin_chunk": (),
    # R, i0, b, n, cluster, threads, bulk, order, stream
    "repro_vat_prim_order": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    # cluster, n, threads, bulk: clusters of that launch the device holds
    # at once (or -error)
    "repro_vat_prim_max_clusters": (_I, _I, _I, _I),
    "repro_cuda_error_string": (_I,),
    # rstar, out, scratch, routes, b, n, stream (the whole op)
    "repro_ivat_from_vat": (_P, _P, _P, _P, _I, _I, _P),
    # its stages alone: rstar, j, w, b, n, stream
    "repro_ivat_parents": (_P, _P, _P, _I, _I, _P),
    # j, w, pre, suf, sparse, flag, routes, b, n, stream
    "repro_ivat_route": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # w, pre, suf, sparse, flag, out, b, n, stream
    "repro_ivat_range": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # rstar, flag, out, b, n, stream (the serial route)
    "repro_ivat_serial": (_P, _P, _P, _I, _I, _P),
    # n / b, n: 4-byte words of one lane's sparse table / of the op's
    # scratch (these two return long long)
    "repro_ivat_sparse_words": (_I,),
    "repro_ivat_scratch_words": (_I, _I),
    # X, n, d, take_sqrt, is_bf16, out, stream
    "repro_metric_aux": (_P, _I, _I, _I, _I, _P, _P),
    # X, aux, i0, cent, rad, slack, margin, b, n, d, block, kind, prune,
    # group, mind, pend, tk1, tk2, nfold, live, nfrom, slots, order, edges,
    # stats, stream
    "repro_prim_persist": (_P, _P, _P, _P, _P, _P, ctypes.c_float, _I, _I,
                           _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P),
    # b, n, d, block, kind, max_group, out (5 ints)
    "repro_prim_persist_plan": (_I, _I, _I, _I, _I, _I, _P),
    # XT, X, aux, q, mind, selected, b, n, d, kind, scratch, out, stream
    "repro_prim_stream_step": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                               _P, _P),
    # args (ReproStreamRecordArgs*, filled once a traversal), t
    "repro_prim_stream_record": (_P, _I),
    # b, n: 8-byte words of a traversal's step scratch (long long)
    "repro_prim_stream_scratch_words": (_I, _I),
    # args (ReproFrontierStepArgs*, filled once a traversal), t
    "repro_prim_frontier_step": (_P, _I),
    # x, count, blocks, out, stream
    "repro_read_floor": (_P, ctypes.c_longlong, _I, _P, _P),
    # Xq, Xc, aq, ac, qid, cid, nq, nc, d, k, kind, out_d, out_i, stream
    "repro_knn_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                       _P),
    # X, aux, ids, b, n, d, k, kind, out_d, out_i, stream
    "repro_knn_topk_batch": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # Xq, Xc, aq, ac, qid, cid, qoff, coff, boff, c, nblocks, d, k, kind,
    # out_d, out_i, stream
    "repro_knn_topk_segmented": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _P, _P, _P),
    "repro_knn_max_k": (),
    "repro_knn_block_rows": (),
}

#: Kernel launches per wrapper since the last ``reset_launch_counts``.  A
#: lane axis launches once for the whole batch: ``masked_argmin``,
#: ``vat_prim_order`` and ``prim_persist`` count (b, ...) calls under their
#: own names, the batched entries of the other kernels under ``*_batch``;
#: ``knn_graph_segmented`` counts the launches that run every cell of an
#: anchored kNN search at once; ``ivat_from_vat`` counts calls of the op,
#: each one C call of its four launches.
LAUNCHES = {"pairwise_dist": 0, "masked_argmin": 0, "ivat_from_vat": 0,
            "prim_persist": 0, "prim_stream_step": 0, "knn_graph": 0,
            "pairwise_dist_batch": 0, "prim_stream_step_batch": 0,
            "knn_graph_batch": 0, "prim_frontier_step": 0,
            "vat_prim_order": 0, "knn_graph_segmented": 0}

#: Most lanes one batched launch takes: the lane is a grid axis
#: (``blockIdx.y`` or ``blockIdx.z``), whose extent CUDA caps at 65,535.
MAX_LANES = 65_535

_LIB = None

#: Lanes one CTA of ``repro_masked_argmin`` reduces (a compile-time constant
#: of prim_update.cu), read once when ``library()`` loads the library.
MASKED_ARGMIN_CHUNK = 0

#: The query rows of one CTA of the kNN kernel (a segmented call's work
#: list counts ceil(q / rows) CTAs a cell); read with the library.
KNN_BLOCK_ROWS = 0

def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def sources() -> list[pathlib.Path]:
    """Every file the library is built from (``.cu`` and headers)."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """The ``nvcc`` to build with: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin; ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "repro_torch needs nvcc to build its CUDA kernels and found none "
        "(set CUDA_HOME or put nvcc on PATH); CPU tensors take the plain "
        "PyTorch versions and need no build")


def _compile(nvcc: str, out: pathlib.Path, workdir: pathlib.Path) -> str:
    """Compile every ``.cu`` in parallel, then link; return the compiler's
    output (ptxas register and shared-memory report included)."""
    procs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = workdir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
        objs.append(str(obj))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out),
                           *objs], capture_output=True, text=True)
    log.append(f"== link\n{link.stdout}{link.stderr}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    return "\n".join(log)


def build() -> pathlib.Path:
    """Build the library if no library of these sources exists; its path."""
    path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_path = pathlib.Path(tmp)
        staged = tmp_path / path.name
        log = _compile(nvcc, staged, tmp_path)
        os.replace(staged, path)  # atomic: a concurrent build loses nothing
    (BUILD_DIR / "build.log").write_text(log)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes set."""
    global _LIB, MASKED_ARGMIN_CHUNK
    global KNN_BLOCK_ROWS
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_ivat_sparse_words.restype = ctypes.c_longlong
        lib.repro_ivat_scratch_words.restype = ctypes.c_longlong
        lib.repro_pairwise_scratch_words.restype = ctypes.c_longlong
        lib.repro_prim_stream_scratch_words.restype = ctypes.c_longlong
        MASKED_ARGMIN_CHUNK = lib.repro_masked_argmin_chunk()
        KNN_BLOCK_ROWS = lib.repro_knn_block_rows()
        _LIB = lib
    return _LIB


def check(err: int, kernel: str) -> None:
    """Raise when a C launch function reported a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t "
                           f"{err} ({msg})")

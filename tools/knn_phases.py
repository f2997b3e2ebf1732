#!/usr/bin/env python3
"""Where the kNN kernel's time goes, phase by phase, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/knn_phases.py

It copies ``src/repro_torch/kernels/csrc/knn_graph.cu`` into
``build/knn_phases/``, adds ``clock64()`` counters around each phase of a
tile (waiting for the staged chunk, the FMA block, the epilogue's screen
and marks, the wait at the barrier before the merge, the merge), builds
that copy with the library's nvcc flags, and times four launches with
CUDA events: the exact kNN graph at the top of its window
(n = 32,768, k = 15) at d = 64 and d = 8, and the anchored search's two
launches on the million-point demo input (``examples/approx_demo.py``'s
blobs, seed 0): the segmented launch over every cell and the assignment.
It prints, for each, the time and the mean cycles a warp spent in each
phase (lane 0 of every warp adds its own).  The counters cost a few
percent; the library itself is not changed.  It exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (anchor in knn_graph.cu, the text that replaces it): the counters.
PROBES = [
    ("namespace {\n\nusing namespace repro_torch;",
     "__device__ unsigned long long g_phase[6];\n"
     "namespace {\n\nusing namespace repro_torch;"),
    ("    stage_chunk(0);\n",
     "    stage_chunk(0);\n"
     "    unsigned long long c_wait = 0, c_gemm = 0, c_epi = 0, c_bar = 0,"
     " c_merge = 0, ta = 0, tb_ = 0;\n"
     "    const unsigned long long t_start = clock64();\n"),
    ("        stage_chunk(g + 1);\n        cp_async_wait_one();\n"
     "        __syncthreads();\n",
     "        ta = clock64();\n        stage_chunk(g + 1);\n"
     "        cp_async_wait_one();\n        __syncthreads();\n"
     "        tb_ = clock64(); c_wait += tb_ - ta; ta = tb_;\n"),
    ("        if (chunk + 1 < nchunks) {\n            __syncthreads();",
     "        tb_ = clock64(); c_gemm += tb_ - ta; ta = tb_;\n"
     "        if (chunk + 1 < nchunks) {\n            __syncthreads();"),
    ("        if (mine) atomicOr(&marks[cur], mine);\n"
     "        __syncthreads();\n",
     "        if (mine) atomicOr(&marks[cur], mine);\n"
     "        tb_ = clock64(); c_epi += tb_ - ta; ta = tb_;\n"
     "        __syncthreads();\n"
     "        tb_ = clock64(); c_bar += tb_ - ta; ta = tb_;\n"),
    ("        // The next tile's chunk barrier orders",
     "        tb_ = clock64(); c_merge += tb_ - ta;\n"
     "        // The next tile's chunk barrier orders"),
    ("    // Lists out, row-major",
     "    if (lane == 0) {\n"
     "        atomicAdd(&g_phase[0], c_wait); atomicAdd(&g_phase[1], c_gemm);\n"
     "        atomicAdd(&g_phase[2], c_epi); atomicAdd(&g_phase[3], c_bar);\n"
     "        atomicAdd(&g_phase[4], c_merge); atomicAdd(&g_phase[5], 1ull);\n"
     "    }\n"
     "    // Lists out, row-major"),
]
READER = '''
extern "C" void knn_phases_read(unsigned long long* out) {
    cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" void knn_phases_reset() {
    unsigned long long z[6] = {0, 0, 0, 0, 0, 0};
    cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
'''
PHASES = ("wait", "gemm", "epilogue", "barrier", "merge")


def build(_build) -> ctypes.CDLL:
    src = (_build.CSRC / "knn_graph.cu").read_text()
    for anchor, text in PROBES:
        if anchor not in src:
            raise SystemExit(f"knn_phases: the kernel changed; no anchor "
                             f"{anchor!r}")
        src = src.replace(anchor, text)
    out = ROOT / "build" / "knn_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "knn_graph_phases.cu", out / "knn_graph_phases.so"
    cu.write_text(src + READER)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("repro_knn_topk", "repro_knn_topk_segmented"):
        getattr(lib, name).argtypes = list(_build.SIGNATURES[name])
    return lib


def measure(torch, lib, label, launch):
    buf = (ctypes.c_ulonglong * 6)()
    launch()
    torch.cuda.synchronize()
    lib.knn_phases_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    lib.knn_phases_read(buf)
    warps = buf[5]
    row = {"case": label, "ms": start.elapsed_time(end), "warps": warps}
    row.update({f"{p}_kcycles_a_warp": buf[i] / warps / 1e3
                for i, p in enumerate(PHASES)})
    print(row, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("knn_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise_dist import metric_aux_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    lib = build(_build)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def exact(X, k):
        n, d = X.shape
        aux = metric_aux_cuda(X, metric="euclidean")
        ids = torch.arange(n, device="cuda")
        dist = torch.empty((n, k), device="cuda")
        idx = torch.empty((n, k), dtype=torch.int64, device="cuda")
        return lambda: lib.repro_knn_topk(
            X.data_ptr(), X.data_ptr(), aux.data_ptr(), aux.data_ptr(),
            ids.data_ptr(), ids.data_ptr(), n, n, d, k, 1, dist.data_ptr(),
            idx.data_ptr(), stream())

    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (64, 8):
        X = torch.randn(32_768, d, device="cuda", generator=gen)
        measure(torch, lib, f"exact n=32768 d={d} k=15", exact(X, 15))

    rng = np.random.default_rng(0)       # approx_demo.py's make_blobs
    centers = rng.normal(scale=20.0, size=(5, 8)).astype(np.float32)
    lab = rng.integers(0, 5, size=1_000_000)
    Xd = np.empty((1_000_000, 8), np.float32)
    for s in range(0, 1_000_000, 100_000):
        Xd[s:s + 100_000] = centers[lab[s:s + 100_000]] + rng.normal(
            size=(100_000, 8)).astype(np.float32)
    Xt = torch.from_numpy(Xd).cuda()
    cells = core.anchor_cells(Xt)
    Xq, Xc = Xt[cells.query], Xt[cells.members]
    aq = metric_aux_cuda(Xq, metric="euclidean")
    ac = metric_aux_cuda(Xc, metric="euclidean")
    rows = lib.repro_knn_block_rows()
    blocks = (cells.qoff[1:] - cells.qoff[:-1] + rows - 1) // rows
    boff = torch.cat([blocks.new_zeros(1), torch.cumsum(blocks, 0)]).to(
        torch.int32)
    nblocks = int(boff[-1])
    dist = torch.empty((Xq.shape[0], 15), device="cuda")
    idx = torch.empty((Xq.shape[0], 15), dtype=torch.int64, device="cuda")
    measure(torch, lib, "anchored cells (segmented)", lambda: (
        lib.repro_knn_topk_segmented(
            Xq.data_ptr(), Xc.data_ptr(), aq.data_ptr(), ac.data_ptr(),
            cells.query.data_ptr(), cells.members.data_ptr(),
            cells.qoff.data_ptr(), cells.coff.data_ptr(), boff.data_ptr(),
            boff.numel() - 1, nblocks, 8, 15, 1, dist.data_ptr(),
            idx.data_ptr(), stream())))
    A = Xt[cells.anchors]
    aA, aX = (metric_aux_cuda(A, metric="euclidean"),
              metric_aux_cuda(Xt, metric="euclidean"))
    no_id = torch.full((Xt.shape[0],), -1, dtype=torch.int64, device="cuda")
    aid = torch.arange(A.shape[0], device="cuda")
    d2 = torch.empty((Xt.shape[0], 2), device="cuda")
    i2 = torch.empty((Xt.shape[0], 2), dtype=torch.int64, device="cuda")
    measure(torch, lib, "anchored assignment", lambda: lib.repro_knn_topk(
        Xt.data_ptr(), A.data_ptr(), aX.data_ptr(), aA.data_ptr(),
        no_id.data_ptr(), aid.data_ptr(), Xt.shape[0], A.shape[0], 8, 2, 1,
        d2.data_ptr(), i2.data_ptr(), stream()))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())

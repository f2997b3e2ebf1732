#!/usr/bin/env python3
"""Where a step of the Prim ordering kernel (``vat_prim_order``, PERF.md
section 6 row 3') spends its time, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/prim_order_phases.py [--src DIR] [--n 128 ... 16384]
        [--b 1 8 ...]

It copies ``csrc/`` of DIR (default: this repository's ``src/``; a parent
commit unpacked under ``build/`` works too) into
``build/prim_order_phases/``, builds ``prim_update.cu`` there once a
variant with the library's nvcc flags, and times one launch of each copy
by CUDA events on a (n, n) euclidean matrix of 32 random features, or on a
(b, n, n) stack of b such matrices, one cluster a matrix, for each b of
``--b``:

- ``full``: the kernel as it is: each step reads and folds the pivot's row
  (from L2 up to n = 2,048, from HBM at 16,384, past the 50 MB L2),
  reduces, exchanges and writes the order; on the cluster kernel with the
  rows read by each thread's loads and, where n % 4 == 0, again with the
  bulk copy (``bulk_step_us``);
- ``smem_row``: the same steps, but every fold after the seed takes its row
  from the frontier in shared memory instead of R: the fold's arithmetic,
  the reduction and the order write, without the row read;
- ``no_fold``: no fold at all, each thread offers one constant key: the
  reduction, the exchange and the order write alone, the step floor of
  that cluster size;
- ``cluster_sync`` and ``cluster_sync_no_fold`` (cluster kernel): the key
  exchange done with plain stores through distributed shared memory and
  one cluster barrier a step instead of st.async on mbarriers, with and
  without the fold.

So a step splits into the row read (full - smem_row), the fold
(smem_row - no_fold) and the floor (no_fold), each in microseconds a step
(a launch's time over n - 1 steps).  On the cluster kernel it runs every
cluster size C at the block size ``prim_block_threads`` picks, and
``full`` also at 128 to 1,024 threads; on an older kernel (one CTA a
matrix) its one shape.  Each ``full`` launch's order is held against the
library's (``vat_prim_order_cuda`` at the same C and row copy, at its own
block size) where DIR is this repository's.  It prints the card's name and power
limit first, one JSON line a measurement, and a ``split`` line for each n
and C; it exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: patch -> (pattern, replacement) applied to prim_update.cu.  ``smem_row``
#: and ``no_fold`` match the step's fold call in the one-CTA kernel
#: (``fold_row<false>(R + q * nn, ...)``) and in the cluster kernel
#: (``fold_row<false>(row, ...)``); ``mind`` is the frontier's values in
#: shared memory in both.  ``cluster_sync`` (cluster kernel only) swaps the
#: key exchange's st.async stores and mbarrier wait for plain stores
#: through distributed shared memory and one cluster barrier a step.
PATCHES = {
    "smem_row": (r"fold_row<false>\((?:R \+ q \* nn|row),",
                 "fold_row<false>(mind,"),
    "no_fold": (r"fold_row<false>\([^;]*\);",
                "repro_torch::pack_key(0.0f, threadIdx.x);"),
    "cluster_sync": (
        r"send_key\(key, smem_addr\(slots \+ rank \* nwarps \+ warp\), "
        r"mbar,\s+lane\);\s+mbar_wait\(mbar, parity\);\s+"
        r"if \(threadIdx\.x == 0\) mbar_expect\(mbar, 8u \* C \* nwarps\);"
        r"\s+__syncwarp\(\);",
        "cg::this_cluster().map_shared_rank(slots, lane)"
        "[rank * nwarps + warp] = key;\n        cg::this_cluster().sync();"),
}
#: variant -> the patches it applies.
VARIANTS = {"full": (), "smem_row": ("smem_row",), "no_fold": ("no_fold",),
            "cluster_sync": ("cluster_sync",),
            "cluster_sync_no_fold": ("cluster_sync", "no_fold")}
#: Variants an older, one-CTA kernel has.
ONE_CTA_VARIANTS = ("full", "smem_row", "no_fold")
THREADS = (128, 256, 512, 1024)


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}, default=str), flush=True)


_BUILT: dict = {}


def build(_build, csrc: pathlib.Path, name: str) -> tuple[ctypes.CDLL, bool]:
    """One copy of prim_update.cu with the variant's patches, built once
    for its text (named by a hash of the patched source, the headers and
    the flags, as the library is); (library, whether it is the cluster
    kernel)."""
    if (csrc, name) not in _BUILT:
        _BUILT[csrc, name] = _build_copy(_build, csrc, name)
    return _BUILT[csrc, name]


def _build_copy(_build, csrc, name):
    src = (csrc / "prim_update.cu").read_text()
    for patch in VARIANTS[name]:
        pattern, text = PATCHES[patch]
        src, count = re.subn(pattern, text, src)
        if count != 1:
            raise SystemExit(f"prim_order_phases: the kernel changed; "
                             f"{patch} matched {count} times")
    headers = sorted(csrc.glob("*.cuh"))
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update(src.encode())
    for header in headers:
        h.update(header.name.encode())
        h.update(header.read_bytes())
    out = ROOT / "build" / "prim_order_phases" / h.hexdigest()[:16]
    so = out / f"{name}.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        for header in headers:
            shutil.copy(header, out / header.name)
        cu = out / f"{name}.cu"
        cu.write_text(src)
        staged = out / f"{name}.{os.getpid()}.so"
        done = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                               "-shared", "-I", str(out), "-o", str(staged),
                               str(cu)], capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"prim_order_phases: nvcc failed on the {name} "
                             f"copy:\n{done.stdout}{done.stderr}")
        os.replace(staged, so)
    lib = ctypes.CDLL(str(so))
    clustered = "repro_vat_prim_max_clusters" in src
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_vat_prim_order.argtypes = (
        [P, P, I, I, I, I, I, P, P] if clustered
        else [P, P, I, I, I, P, P, P, P])
    lib.repro_vat_prim_order.restype = ctypes.c_int
    return lib, clustered


def launcher(torch, lib, clustered, R, i0, order, cluster, threads,
             bulk=False):
    n = R.shape[-1]
    b = R.shape[0] if R.dim() == 3 else 1
    stream = torch.cuda.current_stream().cuda_stream
    if clustered:
        args = (R.data_ptr(), i0.data_ptr(), b, n, cluster, threads,
                int(bulk), order.data_ptr(), stream)
    else:   # the one-CTA kernel, frontier in shared memory
        args = (R.data_ptr(), i0.data_ptr(), b, n, 1, None, None,
                order.data_ptr(), stream)

    def launch():
        err = lib.repro_vat_prim_order(*args)
        if err:
            raise RuntimeError(f"vat_prim_order launch failed: {err}")
    return launch


def event_ms(torch, launch, reps: int) -> float:
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(torch, libs, n: int, reps: int, lib_order=None, b: int = 1):
    """Every variant at every cluster size at n, on one matrix (b = 1) or
    a stack of b; returns the split rows."""
    from repro_torch.kernels.prim_update import (CLUSTER_SIZES, prim_bulk,
                                                 prim_block_threads)
    gen = torch.Generator(device="cuda").manual_seed(n)
    X = torch.randn(*((b,) if b > 1 else ()), n, 32, device="cuda",
                    generator=gen)
    R = torch.cdist(X, X)
    i0 = torch.argmax(torch.amax(R, dim=-1), dim=-1).reshape(-1)
    order = torch.empty(R.shape[:-1], dtype=torch.int64, device="cuda")
    clustered = libs["full"][1]
    splits = []
    for c in CLUSTER_SIZES if clustered else (1,):
        default = prim_block_threads(n, c) if clustered else 1024
        runs = [("full", t, False) for t in
                (THREADS if clustered else (default,))]
        if clustered and prim_bulk(n, c):
            runs.append(("full", prim_block_threads(n, c, True), True))
        runs += [(name, default, False) for name in libs if name != "full"]
        us = {}
        for name, threads, bulk in runs:
            ms = event_ms(torch, launcher(torch, libs[name][0], clustered, R,
                                          i0, order, c, threads, bulk), reps)
            emit("prim-phase", variant=name, n=n, b=b, cluster=c,
                 threads=threads, bulk=bulk, ms=ms,
                 us_a_step=1e3 * ms / max(n - 1, 1))
            if bulk or threads == default:
                us[name + ("_bulk" if bulk else "")] = 1e3 * ms / max(n - 1, 1)
            if name == "full" and lib_order is not None:
                if not torch.equal(order, lib_order(R, i0, c, bulk)):
                    raise SystemExit(f"prim_order_phases: the full copy's "
                                     f"order at n={n} b={b} C={c} threads="
                                     f"{threads} bulk={bulk} != the "
                                     f"library's")
        split = {"n": n, "b": b, "cluster": c, "threads": default,
                 "bulk_threads": (prim_block_threads(n, c, True)
                                  if "full_bulk" in us else None),
                 "step_us": us["full"],
                 "row_read_us": us["full"] - us["smem_row"],
                 "fold_us": us["smem_row"] - us["no_fold"],
                 "floor_us": us["no_fold"],
                 "bulk_step_us": us.get("full_bulk"),
                 "cluster_sync_step_us": us.get("cluster_sync"),
                 "cluster_sync_floor_us": us.get("cluster_sync_no_fold")}
        emit("split", **split)
        splits.append(split)
    return splits


def step_floor_us(torch, n: int, cluster: int, threads: int,
                  reps: int = 3) -> float:
    """The ``no_fold`` copy of this repository's kernel at (n, C, threads):
    microseconds a step of reduction, exchange and order write alone."""
    from repro_torch.kernels import _build
    lib, _ = build(_build, _build.CSRC, "no_fold")
    gen = torch.Generator(device="cuda").manual_seed(n)
    R = torch.rand(n, n, device="cuda", generator=gen)
    i0 = torch.zeros(1, dtype=torch.int64, device="cuda")
    order = torch.empty(n, dtype=torch.int64, device="cuda")
    ms = event_ms(torch, launcher(torch, lib, True, R, i0, order, cluster,
                                  threads), reps)
    return 1e3 * ms / (n - 1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default="src",
                        help="the src/ directory whose kernel to measure")
    parser.add_argument("--n", type=int, nargs="+",
                        default=[128, 512, 2048, 4096, 16384])
    parser.add_argument("--b", type=int, nargs="+", default=[1],
                        help="matrices a launch (a stack where > 1)")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prim_order_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.prim_update import vat_prim_order_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    src = (ROOT / args.src).resolve()
    csrc = src / "repro_torch" / "kernels" / "csrc"
    clustered = build(_build, csrc, "full")[1]
    libs = {name: build(_build, csrc, name) for name in
            (VARIANTS if clustered else ONE_CTA_VARIANTS)}
    ours = src == (ROOT / "src").resolve()

    def lib_order(R, i0, c, bulk):
        return vat_prim_order_cuda(R, i0, cluster=c, bulk=bulk)

    for n in args.n:
        for b in args.b:
            measure(torch, libs, n, args.reps, lib_order if ours else None, b)
    return 0


if __name__ == "__main__":
    sys.exit(main())

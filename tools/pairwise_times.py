#!/usr/bin/env python3
"""Times of the pairwise kernel (PERF.md §6 rows 1 and 2) at the shapes the
port's paths give it, and of the fits around it, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/pairwise_times.py [--src DIR] [--variants]

Without ``--variants`` it imports the port from DIR (default: this
repository's ``src/``) and times its public entry points: the self-matrix
of the vat fit (2,048, 64), a flashvat seed-scan block (2,000 x 7,143, 64),
the ivat fit's matrix (16,384, 32) and the batch of fit_many (8, 2,048,
64), f32 and bf16 storage where the path can take it; ``vat_prim_order``
on the 2,048 matrix right after the pairwise call wrote it (L2 warm) and
after a 128 MiB write evicted it; the seed scan of the flash-50000 fit; and
the vat-2048, ivat-16384, flash-50000 and batch-vat fits.  ``--src`` lets
one call time another checkout's kernel with the same timing code (for
instance the parent commit unpacked under ``build/``), so two versions are
compared on one card in turns.

With ``--variants`` it builds copies of ``csrc/pairwise_dist.cu`` with its
store threshold (PAIRWISE_STREAM_MIN_BYTES) or tile threshold
(PAIRWISE_BIG_TILE_MIN) overridden, times the C entries of each at the same
shapes, holds every copy's matrix bit for bit against the library's, and
times ``vat_prim_order`` after each copy wrote the 2,048 matrix.

Times are device time (torch.profiler, kernels only) and stream time
(CUDA events around back-to-back calls, host launch gaps included); fits
are host wall time ending in a synchronize.  It prints the card's name
and power limit first and one JSON line a measurement; it exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: name -> (define, value) of each built copy of pairwise_dist.cu.
VARIANTS = {
    "write-back": ("PAIRWISE_STREAM_MIN_BYTES", 1 << 62),
    "streaming": ("PAIRWISE_STREAM_MIN_BYTES", 0),
    "tile-64": ("PAIRWISE_BIG_TILE_MIN", 1 << 62),
    "tile-128": ("PAIRWISE_BIG_TILE_MIN", 0),
}


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}, default=str), flush=True)


def shapes(torch):
    """(label, X, Y or None, b) at the main path's shapes; b > 1 a batch."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    return [("self 2048x64", randn(2048, 64), None, 1),
            ("seed block 2000x7143x64", randn(2000, 64), randn(7143, 64), 1),
            # the same block with rows of a multiple of 4 (float4 stores)
            ("block 2000x7144x64", randn(2000, 64), randn(7144, 64), 1),
            ("self 16384x32", randn(16384, 32), None, 1),
            ("batch 8x2048x64", randn(8, 2048, 64), None, 8)]


def cost(cs, X, Y, b):
    n, d = X.shape[-2:]
    nbytes, nops = cs.pairwise_cost(n, None if Y is None else Y.shape[0], d)
    return cs.bound_ms(b * nbytes, b * nops)


def evict(torch):
    """Write 128 MiB, more than the 50 MB L2 holds."""
    buf = torch.empty(32 << 20, device="cuda")
    buf.fill_(1.0)
    return buf


def prim_after(torch, cs, ops, write, reps=5):
    """vat_prim_order on the 2,048 matrix, ms by CUDA events: right after
    ``write()`` produced it (its lines still in L2), and after the L2 was
    overwritten; each the median of ``reps`` single calls."""
    warm, cold = [], []
    for _ in range(reps):
        R = write()
        i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
        R = write()
        _, ms = cs.event_once_ms(torch, lambda: ops.vat_prim_order(R, i0))
        warm.append(ms)
        evict(torch)
        _, ms = cs.event_once_ms(torch, lambda: ops.vat_prim_order(R, i0))
        cold.append(ms)
    return statistics.median(warm), statistics.median(cold)


def time_public(torch, cs):
    from repro_torch.kernels import ops
    from repro_torch.kernels.pairwise_dist import (pairwise_dist_batch_cuda,
                                                  pairwise_dist_cuda)
    for label, X, Y, b in shapes(torch):
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and b > 1:
                continue
            Xc = X.to(dtype)
            Yc = None if Y is None else Y.to(dtype)
            if b > 1:
                fn = lambda: pairwise_dist_batch_cuda(Xc)   # noqa: E731
            elif Yc is None:
                fn = lambda: ops.pairwise_dist(Xc)   # noqa: E731
            else:
                fn = lambda: pairwise_dist_cuda(Xc, Yc)   # noqa: E731
            bound, by = cost(cs, X, Y, b)
            emit("pairwise", shape=label, dtype=str(dtype)[6:],
                 ms=cs.device_ms(torch, fn, reps=20, label=label),
                 event_ms=cs.event_ms(torch, fn, reps=20),
                 bound_ms=bound, bound_by=by)
    X = shapes(torch)[0][1]
    warm, cold = prim_after(torch, cs, ops, lambda: ops.pairwise_dist(X))
    emit("vat_prim_order 2048", after_pairwise_ms=warm, after_evict_ms=cold)

    import repro_torch as rt
    from repro_torch.core.vat import _streamed_seed_pivot
    X50 = torch.from_numpy(cs.blobs(50_000, 64, k=8, seed=0)).cuda()
    scans = [cs.event_once_ms(torch, lambda: _streamed_seed_pivot(
        X50, metric="euclidean"))[1] for _ in range(4)]
    emit("seed scan 50000x64", ms=statistics.median(scans[1:]))
    fits = (("vat-2048", lambda: rt.FastVAT().fit(Xv), 7),
            ("ivat-16384", lambda: rt.FastVAT(method="ivat").fit(Xi), 3),
            ("flash-50000", lambda: rt.FastVAT().fit(Xf), 3),
            ("batch-vat-8x2048", lambda: rt.FastVAT().fit_many(Xb), 5))
    Xv = cs.blobs(2048, 64, k=8, seed=0)
    Xi = cs.blobs(16384, 32, k=8, seed=1)
    Xf = cs.blobs(50_000, 64, k=8, seed=0)
    Xb = np.stack([cs.blobs(2048, 64, k=8, seed=s) for s in range(8)])
    for label, fit, reps in fits:
        walls = [cs.wall_s(torch, fit)[1] for _ in range(reps)]
        emit("fit", cell=label, first_s=walls[0],
             again_median_s=statistics.median(walls[1:]))


def build_variants(build) -> dict:
    """Compile each copy of pairwise_dist.cu at once; name -> CDLL."""
    out = ROOT / "build" / "pairwise_times"
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "pairwise_dist.cu"
    procs = {}
    for name, (define, value) in VARIANTS.items():
        so = out / f"pairwise_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
             f"-D{define}={value}ll", "-I", str(build.CSRC), "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"pairwise_times: nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(str(so))
        bind(build, lib)
        libs[name] = lib
    return libs


def bind(build, lib) -> None:
    """Argument and result types of a copy's C entries, as the library's."""
    for entry in ("repro_pairwise_dist", "repro_pairwise_dist_batch",
                  "repro_pairwise_scratch_words"):
        fn = getattr(lib, entry)
        fn.argtypes = list(build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
    lib.repro_pairwise_scratch_words.restype = ctypes.c_longlong


def raw_call(torch, lib, X, Y, b):
    """A closure that runs one C entry of ``lib`` (euclidean, gram) into a
    fresh matrix, as the library's wrappers call theirs, and returns it."""
    n, d = X.shape[-2:]
    m = n if Y is None else Y.shape[0]
    bf16 = int(X.dtype == torch.bfloat16)
    stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731

    def run():
        out = torch.empty((b, n, m) if b > 1 else (n, m), device="cuda")
        words = lib.repro_pairwise_scratch_words(b, n, m, d, int(Y is None))
        scratch = torch.empty(words, device="cuda")
        if b > 1:
            err = lib.repro_pairwise_dist_batch(
                X.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n, d, 1,
                bf16, stream())
        else:
            err = lib.repro_pairwise_dist(
                X.data_ptr(), (X if Y is None else Y).data_ptr(),
                scratch.data_ptr(), out.data_ptr(), n, m, d, 1, bf16,
                int(Y is None), int(Y is None), stream())
        if err != 0:
            raise SystemExit(f"pairwise_times: launch failed, error {err}")
        return out
    return run


def time_variants(torch, cs, build):
    from repro_torch.kernels import ops
    from repro_torch.kernels.pairwise_dist import pairwise_dist_batch_cuda
    libs = build_variants(build)
    cases = shapes(torch)
    for label, X, Y, b in cases:
        if b > 1:
            want = pairwise_dist_batch_cuda(X)
        else:
            want = ops.pairwise_dist(X, Y)
        bound, by = cost(cs, X, Y, b)
        row = {"shape": label, "bound_ms": bound, "bound_by": by}
        for name, lib in libs.items():
            fn = raw_call(torch, lib, X, Y, b)
            if not torch.equal(fn(), want):
                raise SystemExit(f"pairwise_times: {name} differs from the "
                                 f"library at {label}")
            row[f"{name}_ms"] = cs.device_ms(torch, fn, reps=20,
                                             label=f"{name} {label}")
            row[f"{name}_event_ms"] = cs.event_ms(torch, fn, reps=20)
        emit("pairwise variants", **row)
    X = cases[0][1]
    for name, lib in libs.items():
        warm, cold = prim_after(torch, cs, ops, raw_call(torch, lib, X, None,
                                                         1))
        emit("vat_prim_order 2048 after variant", variant=name,
             after_pairwise_ms=warm, after_evict_ms=cold)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pairwise_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _build as build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.library()
    emit("source", src=args.src, library=str(build.build()))
    if args.variants:
        time_variants(torch, cs, build)
    else:
        time_public(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the pairwise kernel's time goes, phase by phase, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/pairwise_phases.py

It copies ``src/repro_torch/kernels/csrc/pairwise_dist.cu`` into
``build/pairwise_phases/``, adds ``clock64()`` counters around each phase of
a tile (issuing the next chunk's copies, waiting for the current chunk, the
FMA loop, the barrier after it, finishing and storing block (I, J), storing
the mirror), builds that copy with the library's nvcc flags, and times one
launch of the tiles (euclidean, gram form, f32) at the shapes of
``tools/pairwise_times.py`` by CUDA events.  It prints, for each, the time
and the mean cycles a warp spent in each phase (lane 0 of every warp adds
its own; the mirror's mean is over the warps of tiles that have one).  The
counters slow the kernel (their atomics and clock reads), so each case is
also timed by CUDA events on the library itself and on a second copy that
skips its global stores (``ms_without_stores``: the tiles' arithmetic,
staging and finish alone).  The library itself is not changed.  It exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

from pairwise_times import bind, raw_call, shapes

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (anchor in pairwise_dist.cu, the text that replaces it): the counters.
PROBES = [
    ("namespace {\n\nusing namespace repro_torch;",
     "__device__ unsigned long long g_phase[9];\n"
     "namespace {\n\nusing namespace repro_torch;"),
    ("    stage_chunk(0);\n",
     "    stage_chunk(0);\n"
     "    unsigned long long c_stage = 0, c_wait = 0, c_fma = 0, c_bar = 0,"
     " ta = 0, tb_ = 0;\n"),
    ("        stage_chunk(g + 1);\n        cp_async_wait_one();\n"
     "        __syncthreads();\n",
     "        ta = clock64();\n        stage_chunk(g + 1);\n"
     "        tb_ = clock64(); c_stage += tb_ - ta; ta = tb_;\n"
     "        cp_async_wait_one();\n        __syncthreads();\n"
     "        tb_ = clock64(); c_wait += tb_ - ta; ta = tb_;\n"),
    ("        __syncthreads();   // the buffer is refilled two chunks on, or\n",
     "        tb_ = clock64(); c_fma += tb_ - ta; ta = tb_;\n"
     "        __syncthreads();   // the buffer is refilled two chunks on, or\n"
     "        tb_ = clock64(); c_bar += tb_ - ta; ta = tb_;\n"),
    ("    if (!tri || I == J) return;   // CTA-uniform\n",
     "    tb_ = clock64();\n"
     "    if ((threadIdx.x & 31) == 0) {\n"
     "        atomicAdd(&g_phase[0], c_stage); atomicAdd(&g_phase[1], c_wait);\n"
     "        atomicAdd(&g_phase[2], c_fma); atomicAdd(&g_phase[3], c_bar);\n"
     "        atomicAdd(&g_phase[4], tb_ - ta); atomicAdd(&g_phase[5], 1ull);\n"
     "    }\n"
     "    if (!tri || I == J) return;   // CTA-uniform\n"
     "    ta = clock64();\n"),
    ("                     stream);\n        }\n        return;\n    }\n",
     "                     stream);\n        }\n"
     "        tb_ = clock64();\n"
     "        if ((threadIdx.x & 31) == 0) {\n"
     "            atomicAdd(&g_phase[6], tb_ - ta);"
     " atomicAdd(&g_phase[7], 1ull);\n"
     "        }\n        return;\n    }\n"),
    ("                     + (rr & 3)], stream);\n    }\n}\n",
     "                     + (rr & 3)], stream);\n    }\n"
     "    tb_ = clock64();\n"
     "    if ((threadIdx.x & 31) == 0) {\n"
     "        atomicAdd(&g_phase[6], tb_ - ta); atomicAdd(&g_phase[7], 1ull);\n"
     "    }\n}\n"),
]
#: (anchor, replacement) of a second copy that skips its global stores
#: (a value of -1 is never written: every entry is >= 0), to time the tiles
#: without them.
NO_STORES = [
    ("    if (stream) __stcs(p, v);\n    else *p = v;\n",
     "    if (v == -1.0f) *p = v;\n"),
    ("    if (stream) __stcs(reinterpret_cast<float4*>(p), v);\n"
     "    else *reinterpret_cast<float4*>(p) = v;\n",
     "    if (v.x == -1.0f) *reinterpret_cast<float4*>(p) = v;\n"),
]
READER = '''
extern "C" void pairwise_phases_read(unsigned long long* out) {
    cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" void pairwise_phases_reset() {
    unsigned long long z[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
'''
PHASES = ("stage", "wait", "fma", "barrier", "block_store")


def build(_build, probes, name: str) -> ctypes.CDLL:
    src = (_build.CSRC / "pairwise_dist.cu").read_text()
    for anchor, text in probes:
        if anchor not in src:
            raise SystemExit(f"pairwise_phases: the kernel changed; no "
                             f"anchor {anchor!r}")
        src = src.replace(anchor, text)
    out = ROOT / "build" / "pairwise_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src + (READER if probes is PROBES else ""))
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    bind(_build, lib)
    return lib


def event_ms(torch, launch, reps: int = 20) -> float:
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(torch, lib, label, launch):
    buf = (ctypes.c_ulonglong * 9)()
    launch()
    torch.cuda.synchronize()
    lib.pairwise_phases_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    lib.pairwise_phases_read(buf)
    warps = buf[5]
    row = {"case": label, "ms": start.elapsed_time(end), "warps": warps}
    row.update({f"{p}_kcycles_a_warp": buf[i] / warps / 1e3
                for i, p in enumerate(PHASES)})
    row["mirror_kcycles_a_warp"] = buf[6] / buf[7] / 1e3 if buf[7] else 0.0
    print(row, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pairwise_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    lib = build(_build, PROBES, "pairwise_phases")
    bare = build(_build, NO_STORES, "pairwise_no_stores")
    plain = _build.library()
    for label, X, Y, b in shapes(torch):
        measure(torch, lib, label, raw_call(torch, lib, X, Y, b))
        print({"case": label,
               "ms": event_ms(torch, raw_call(torch, plain, X, Y, b)),
               "ms_without_stores": event_ms(torch, raw_call(torch, bare, X,
                                                             Y, b))},
              flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())

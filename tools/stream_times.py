#!/usr/bin/env python3
"""Times of the step kernels (PERF.md §6 rows 8, 9 and 10) as the
step-by-step engines run them, and of the fits around them, on one NVIDIA
GPU.

Run from the repository root:

    python3 tools/stream_times.py [--src DIR] [--no-fits]

It imports the port from DIR (default: this repository's ``src/``), so one
call can time another checkout (for instance the parent commit unpacked
under ``build/``) with the same timing code, in turns on one card.  At the
flash path's shapes — (50,000, 64), and (4, 50,000, 64) for the batch —
it times one step of each engine as the engine's loop runs it: where the
port has step objects (``StreamRecord``, ``FrontierStep``) one call of
the object, otherwise the loop body of the older engines (the single-call
wrapper, and for the stepwise engine its three torch ops).  For each: the
device time of every operation the step puts on the card and of the step
kernels alone (torch.profiler), the device operations a step, and the
stream time a step (CUDA events over back-to-back steps).  Where the
library has ``repro_read_floor``, it times a kernel that only reads the
same bytes of X, warm: the floor a step's read of X is held against,
beside the HBM bound.  Unless ``--no-fits``: the stepwise fit at n =
50,000, the batched stepwise fit of four lanes, and the sharded engine over
an NCCL group of one rank, each with device operations a step from a
traced run at n = 8,192.  It prints the card's name and power limit first
and one JSON line a measurement; it exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: name -> the defines of each built copy of prim_stream.cu (``--variants``).
VARIANTS = {f"unroll-{u}": {"PRIM_STREAM_UNROLL": u} for u in (16, 32, 64)}


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}, default=str), flush=True)


def step_kernel_ms(cs, prof) -> float:
    """Device ms of the kernels of prim_stream.cu in a trace."""
    return sum(v for k, v in cs.kernel_device_ms(prof).items()
               if "stream_step" in k or "frontier_step" in k
               or "reduce" in k)


def time_step(torch, cs, label, fn, nbytes_nops, floor_ms, reps=200):
    """One line for one engine step ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    bound, by = cs.bound_ms(*nbytes_nops)
    emit("step", kernel=label,
         step_ms=sum(cs.kernel_device_ms(prof).values()) / reps,
         kernel_ms=step_kernel_ms(cs, prof) / reps,
         device_ops=cs.device_launches(prof) / reps,
         event_ms=cs.event_ms(torch, fn, reps=reps),
         bound_ms=bound, bound_by=by, read_floor_ms=floor_ms)


def time_steps(torch, cs, build, has_steps):
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import prim_stream as ps
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 50_000, 64
    X = torch.from_numpy(cs.blobs(n, d, k=8, seed=0)).cuda()
    aux = ops.metric_aux(X)
    floor = None
    if hasattr(build.library(), "repro_read_floor"):
        floor = cs.read_floor_ms(torch, build, X)
    # row 8: the stepwise engine's step, pivot 17, 30 % of lanes selected
    mind = torch.rand(n, device="cuda", generator=gen) * 50.0
    sel = torch.rand(n, device="cuda", generator=gen) < 0.3
    sel[17] = True
    order = torch.zeros(n, dtype=torch.int64, device="cuda")
    order[0] = 17
    edges = torch.zeros(n, device="cuda")
    if has_steps:
        step = ps.StreamRecord(X, aux, mind, sel, order, edges)
        fn = lambda: step(1)   # noqa: E731
    else:
        q = order[0:1]

        def fn():   # the parent engine's loop body
            _, ev, nq = ps.prim_stream_step_cuda(X, aux, q, mind, sel)
            sel.index_fill_(0, nq.view(1), True)
            order[1:2] = nq.view(1)
            edges[1:2] = ev.view(1)
    time_step(torch, cs, "prim_stream_step", fn, cs.stream_step_cost(n, d),
              floor)
    # row 9: the frontier step of one rank's shard, every lane live
    width = ref.slot_width(d)
    zero = torch.zeros((), device="cuda")
    i0 = torch.tensor(17, device="cuda")
    table = ref.make_slot(zero, i0, zero, aux[i0], X[i0], width).view(1, -1)
    fmind = torch.full((n,), ref.UNSEEN, device="cuda")
    slot = torch.empty(width, device="cuda")
    forder = torch.zeros(n, dtype=torch.int64, device="cuda")
    fedges = torch.zeros(n, device="cuda")
    if has_steps:
        fstep = ps.FrontierStep(X, aux, table, fmind, slot, forder, fedges)
        fn = lambda: fstep(0)   # noqa: E731
    else:
        fn = lambda: ps.prim_frontier_step_cuda(   # noqa: E731
            X, aux, table, fmind, slot, forder, fedges, 0)
    time_step(torch, cs, "prim_frontier_step", fn,
              cs.frontier_step_cost(n, d), floor)
    # row 10: the batched step of four lanes
    b = 4
    Xs = torch.from_numpy(np.stack([cs.blobs(n, d, k=8, seed=s)
                                    for s in range(b)])).cuda()
    bfloor = None if floor is None else cs.read_floor_ms(torch, build, Xs)
    baux = ops.metric_aux(Xs)
    bmind = torch.full((b, n), torch.inf, device="cuda")
    bsel = torch.zeros((b, n), dtype=torch.bool, device="cuda")
    bsel[:, 17] = True
    border = torch.full((b, n), 17, dtype=torch.int64, device="cuda")
    bedges = torch.zeros((b, n), device="cuda")
    if has_steps:
        bstep = ps.StreamRecord(Xs, baux, bmind, bsel, border, bedges)
        fn = lambda: bstep(1)   # noqa: E731
    else:
        bq = border[:, 0].contiguous()

        def fn():   # the parent engine's loop body
            _, ev, nq = ps.prim_stream_step_batch_cuda(Xs, baux, bq, bmind,
                                                       bsel)
            border[:, 1] = nq
            bedges[:, 1] = ev
            bsel.scatter_(1, border[:, 1].view(b, 1), True)
    nbytes, nops = cs.stream_step_cost(n, d)
    time_step(torch, cs, "prim_stream_step_batch", fn,
              (b * nbytes, b * nops), bfloor)


def traced_ops(torch, cs, run, name):
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = cs.wall_s(torch, run)
    per_step, steps = cs.ops_per_step(prof, name)
    return {"traced_wall_ms": wall * 1e3, "device_ops_per_step": per_step,
            "traced_steps": steps,
            "traced_fit_ops_per_step": cs.device_launches(prof) / steps}


def time_fits(torch, cs):
    import numpy as np
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch import core
    n, d = 50_000, 64
    X = cs.blobs(n, d, k=8, seed=0)
    Xs = np.stack([cs.blobs(n, d, k=8, seed=s) for s in range(4)])
    Xt = torch.from_numpy(X).cuda()
    Xt8 = Xt[:8_192].contiguous()
    Xs8 = torch.from_numpy(Xs[:, :8_192]).cuda().contiguous()
    _, wall = cs.wall_s(torch, lambda: rt.FastVAT(turbo=False).fit(X))
    emit("fit", cell="flash-stepwise", fit_wall_s=wall,
         us_per_step=wall * 1e6 / (n - 1),
         **traced_ops(torch, cs, lambda: core.vat_matrix_free(
             Xt8, turbo=False), "stream_step_kernel"))
    _, wall = cs.wall_s(torch, lambda: rt.FastVAT(turbo=False).fit_many(Xs))
    emit("fit", cell="batch-flash fit_stepwise", fit_wall_s=wall,
         us_per_step=wall * 1e6 / (n - 1),
         **traced_ops(torch, cs, lambda: core.vat_matrix_free_batch(
             Xs8, turbo=False), "stream_step_kernel"))
    cs.init_world_of_one(torch, dist)
    try:
        _, wall = cs.wall_s(torch, lambda: core.vat_matrix_free_sharded(Xt))
        emit("fit", cell="shard-path", fit_wall_s=wall,
             us_per_step=wall * 1e6 / n,
             **traced_ops(torch, cs, lambda: core.vat_matrix_free_sharded(
                 Xt8), "frontier_step_kernel"))
    finally:
        dist.destroy_process_group()


def build_variants(build) -> dict:
    """Compile each copy of prim_stream.cu at once; name -> CDLL with the
    step entries bound as the library's."""
    out = ROOT / "build" / "stream_times"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        so = out / f"prim_stream_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
             *(f"-D{k}={v}" for k, v in defines.items()),
             "-I", str(build.CSRC), "-o", str(so),
             str(build.CSRC / "prim_stream.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"stream_times: nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(str(so))
        for entry in ("repro_prim_stream_record", "repro_prim_frontier_step"):
            fn = getattr(lib, entry)
            fn.argtypes = list(build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants(torch, cs, build):
    """Each copy's steps, run through the library's step objects with the
    copy's C entry: a traversal at n = 4,096 held bit for bit against the
    library's, then one step's device time at (50,000, 64) and (4, 50,000,
    64)."""
    import numpy as np
    from repro_torch import core
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import prim_stream as ps
    libs = build_variants(build)
    n, d, b = 50_000, 64, 4
    X = torch.from_numpy(cs.blobs(n, d, k=8, seed=0)).cuda()
    Xs = torch.from_numpy(np.stack([cs.blobs(n, d, k=8, seed=s)
                                    for s in range(b)])).cuda()
    X4 = X[:4_096].contiguous()
    want = core.vat_matrix_free(X4, turbo=False)
    width = ref.slot_width(d)

    def record(Xr, variant, i0=17):
        lead = Xr.shape[:-1]
        aux = ops.metric_aux(Xr)
        mind = torch.full(lead, torch.inf, device="cuda")
        sel = torch.zeros(lead, dtype=torch.bool, device="cuda")
        order = torch.zeros(lead, dtype=torch.int64, device="cuda")
        edges = torch.zeros(lead, device="cuda")
        order[..., 0] = i0
        sel[..., i0] = True
        step = ps.StreamRecord(Xr, aux, mind, sel, order, edges)
        step._fn = libs[variant].repro_prim_stream_record
        return step, order, edges

    def frontier(Xr, variant, i0=17):
        aux = ops.metric_aux(Xr)
        i0 = torch.tensor(i0, device="cuda")
        zero = torch.zeros((), device="cuda")
        table = ref.make_slot(zero, i0, zero, aux[i0], Xr[i0],
                              width).view(1, -1)
        nr = Xr.shape[0]
        mind = torch.full((nr,), ref.UNSEEN, device="cuda")
        slot = torch.empty(width, device="cuda")
        order = torch.zeros(nr, dtype=torch.int64, device="cuda")
        edges = torch.zeros(nr, device="cuda")
        step = ps.FrontierStep(Xr, aux, table, mind, slot, order, edges)
        step._fn = libs[variant].repro_prim_frontier_step
        return step, table, slot, order, edges

    seed = int(want.order[0])
    for name in libs:
        step, order, edges = record(X4, name, seed)
        for t in range(1, 4_096):
            step(t)
        fstep, table, slot, forder, fedges = frontier(X4, name, seed)
        for t in range(4_096):
            fstep(t)
            table.copy_(slot.view(1, -1))
        same = bool(torch.equal(order, want.order)
                    and torch.equal(edges, want.edges)
                    and torch.equal(forder, want.order)
                    and torch.equal(fedges, want.edges))
        if not same:
            raise SystemExit(f"stream_times: {name} differs from the library")
        row = {"variant": name, **VARIANTS[name], "bitwise_n4096": same}
        step = record(X, name)[0]
        row["prim_stream_step_ms"] = cs.device_ms(
            torch, lambda: step(1), reps=200, label=name)
        fstep = frontier(X, name)[0]
        row["prim_frontier_step_ms"] = cs.device_ms(
            torch, lambda: fstep(0), reps=200, label=name)
        bstep = record(Xs, name)[0]
        row["prim_stream_step_batch_ms"] = cs.device_ms(
            torch, lambda: bstep(1), reps=200, label=name)
        emit("step variants", **row)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--no-fits", action="store_true")
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _build as build
    from repro_torch.kernels import prim_stream as ps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.library()
    has_steps = hasattr(ps, "StreamRecord")
    emit("source", src=args.src, library=str(build.build()),
         step_objects=has_steps)
    if args.variants:
        time_variants(torch, cs, build)
        return 0
    time_steps(torch, cs, build, has_steps)
    if not args.no_fits:
        time_fits(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

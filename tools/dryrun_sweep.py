#!/usr/bin/env python3
"""The dry run's coverage and its largest buffers, on the host (no card).

Run from the repository root:

    python3 tools/dryrun_sweep.py                 # every arch's smoke config
    python3 tools/dryrun_sweep.py --where --out sweep.json
    python3 tools/dryrun_sweep.py --cell gemma-2b train_4k --largest 12
    python3 tools/dryrun_sweep.py --cell internvl2-1b train_4k --optimized
    python3 tools/dryrun_sweep.py --exp A3_ep2d_cechunk_dots --largest 16
    python3 tools/dryrun_sweep.py --table build/dryrun_all.json

Without ``--cell`` it traces each arch's smoke config (train, prefill and
decode at B 8, S 64) on the (4, 2) mesh of a fake world of 8 ranks, the
step ``launch/dryrun.py`` runs on production cells, and prints one JSON
line a cell: ok or the error, per-rank FLOPs, collectives by count, the
ops that ``ReplicateFallback`` had to unshard (they depend on the torch
version) and the peak bytes a rank; ``--out`` also writes the lines to a
JSON file.  With ``--cell ARCH SHAPE`` it runs that production cell
(``dryrun.run_cell``, 16 x 16 of a fake world of 512) and prints its
record and the ``--largest`` buffers live at its peak, by the op that
made them, their local shape and dtype.  With ``--where`` each sweep line
(and the cell) also gives, for every op that ``ReplicateFallback``
unsharded, where it was called (file:line in ``repro_torch``; for a
backward op the line of the forward op it differentiates, which
autograd's anomaly mode keeps) and its inputs' placements, with a count
(for a cell, also the result bytes a rank of the collectives that cost);
``--multi-pod`` takes a cell to the 2 x 16 x 16 mesh, ``--optimized`` to
the flags of ``launch.dryrun --optimized``, and ``--out`` writes its
record; ``--exp NAME`` runs a ``launch.perf`` experiment's cell, mesh and
flags as ``--cell`` does.
``--table`` prints the records of a ``launch.dryrun --out`` file as a
markdown table.  Every figure is a count on a fake world, not a time.  A
full-width cell needs the memory of the card machine's host for its
bookkeeping, not for tensors (the local tensors are "meta").
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402


class LargestCensus(D.Census):
    """``Census`` that also keeps what was live at the peak, by op, local
    shape and dtype."""

    made: list = []

    def __init__(self, args):
        super().__init__(args)
        self._live: dict[int, tuple] = {}
        self._op = "?"
        self.at_peak: list = []
        LargestCensus.made.append(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen[st] = True
            n, key = st.nbytes(), id(st)
            self._live[key] = (self._op, tuple(t.shape), str(t.dtype), n)
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
                if not self.at_peak or self.live > 1.02 * self.at_peak[0]:
                    agg = collections.Counter()
                    for op, shape, dtype, nb in self._live.values():
                        agg[(op, shape, dtype)] += nb
                    self.at_peak = [self.live, agg.most_common(64)]

            def free(n=n, key=key):
                self.live -= n
                self._live.pop(key, None)
            weakref.finalize(st, free)


class WhereFallback(D.ReplicateFallback):
    """``ReplicateFallback`` that also notes each unsharded op's call
    site and its inputs' placements."""

    made: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.where = collections.Counter()
        self.moved = collections.Counter()
        WhereFallback.made.append(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        before = sum(self.ops.values())
        moved = self._moved()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if sum(self.ops.values()) > before:
            pl = [",".join(str(p) for p in t.placements)
                  for t in tree_leaves((args, kwargs or {}))
                  if isinstance(t, DTensor)]
            key = (f"{func.name().split('::')[-1]} @ {_site()} "
                   f"[{' | '.join(pl)}]")
            self.where[key] += 1
            self.moved[key] += self._moved() - moved
        return out

    def _moved(self) -> int:
        """Result bytes of the collectives counted so far, a rank."""
        c = self._census
        return 0 if c is None else sum(v["bytes"] for v in c.coll.values())


_SITE = re.compile(r'File "[^"]*/(repro_torch/[\w/]+\.py)", line (\d+)')


def _site() -> str:
    """The innermost ``repro_torch/models`` frame of the op's call; else,
    in a backward, the forward line that the running node differentiates;
    else the innermost ``repro_torch`` frame."""
    stack = traceback.extract_stack()
    for f in reversed(stack):
        if "/repro_torch/models/" in f.filename:
            return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
    node = torch._C._current_autograd_node()
    tb = getattr(node, "metadata", {}).get("traceback_") if node else None
    hits = [m for m in _SITE.findall("".join(tb or []))
            if "/models/" in m[0]]
    if hits:
        return f"bwd {hits[-1][0].split('repro_torch/')[-1]}:{hits[-1][1]}"
    for f in reversed(stack):
        if "/repro_torch/" in f.filename and "/launch/" not in f.filename:
            return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
    return f"bwd {type(node).__name__}" if node else "?"


def sweep(where: bool = False, out: str = "") -> None:
    from torch.distributed.device_mesh import init_device_mesh
    D.fake_world(8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    lines = []
    for arch in sorted(ARCHS):
        for kind in ("train", "prefill", "decode"):
            cfg = D._pick_cfg(smoke_config(arch), kind, {})
            t0 = time.perf_counter()
            try:
                with torch.autograd.set_detect_anomaly(where,
                                                       check_nan=False):
                    rec = D.trace_step(cfg, ShapeConfig("t", 64, 8, kind),
                                       mesh, tc=TrainConfig()
                                       if kind == "train" else None)
                line = {"ok": True, "flops_per_device":
                        rec["flops_per_device"],
                        "collectives": {k: v["count"] for k, v in
                                        rec["collectives"].items()},
                        "replicated_ops": rec["replicated_ops"],
                        "peak_bytes": rec["peak_bytes"]}
                if where:
                    line["where"] = dict(WhereFallback.made[-1].where)
            except Exception as e:  # noqa: BLE001 — report and go on
                line = {"ok": False, "error": f"{type(e).__name__}: "
                        f"{str(e)[-300:]}", "at": [
                            f"{f.filename.split('/')[-1]}:{f.lineno}"
                            for f in traceback.extract_tb(e.__traceback__)
                            if "repro_torch" in f.filename][-3:]}
            line = {"arch": arch, "kind": kind,
                    "s": round(time.perf_counter() - t0, 1), **line}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if out:
                with open(out, "w") as f:
                    json.dump(lines, f, indent=1)


def one_cell(arch: str, shape: str, largest: int, where: bool = False,
             multi_pod: bool = False, out: str = "",
             over: dict | None = None) -> None:
    D.Census = LargestCensus
    with torch.autograd.set_detect_anomaly(where, check_nan=False):
        rec = D.run_cell(arch, shape, multi_pod=multi_pod, overrides=over)
    print(json.dumps(rec), flush=True)
    if where:
        fb = WhereFallback.made[-1]
        rec["where"] = {k: {"count": n, "bytes": fb.moved[k]}
                        for k, n in fb.where.items()}
        print(json.dumps({"where": rec["where"]}))
    if out:
        with open(out, "w") as f:
            json.dump([rec], f, indent=1)
    live, top = LargestCensus.made[-1].at_peak
    print(json.dumps({"live_at_peak_bytes": live}))
    for (op, shp, dtype), nb in top[:largest]:
        print(json.dumps({"bytes": nb, "op": op, "local_shape": shp,
                          "dtype": dtype}))


def _table_cell(r) -> str:
    if r is None:
        return "not run"
    if not r.get("ok"):
        host = (f" ({r['wall_s']} s, {r['host_peak_rss_gb']} GB host)"
                if "wall_s" in r else "")
        return f"**no**: {r['error'][:100]}{host}"
    c = {k: v["count"] for k, v in r["collectives"].items()}
    rep = ", ".join(f"{k} {v}" for k, v in r["replicated_ops"].items())
    return (f"{r['flops_per_device']:.4g}; {r['peak_bytes'] / 1e9:.2f}; "
            f"{c.get('all-gather', 0)}/{c.get('reduce-scatter', 0)}/"
            f"{c.get('all-reduce', 0)}; {{{rep}}}; {r['lower_s']}")


def table(path: str) -> None:
    """A markdown table of a ``launch.dryrun --out`` file's records, one
    row a cell with a column a mesh: FLOPs a rank; peak GB a rank;
    all-gathers/reduce-scatters/all-reduces; ``replicated_ops``;
    ``lower_s`` — or the error, with the trace's wall and the host's
    peak when the cell ran in a process of its own."""
    from repro_torch.configs import SHAPES, cells
    with open(path) as f:
        recs = {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}
    meshes = ("16x16", "2x16x16")
    print("| arch | shape | " + " | ".join(meshes) + " |")
    print("|---|---|" + "---|" * len(meshes))
    for arch in ARCHS:
        for shape in (s for s in SHAPES if s in cells(arch)):
            row = [_table_cell(recs.get((arch, shape, m))) for m in meshes]
            print(f"| {arch} | {shape} | " + " | ".join(row) + " |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs=2, metavar=("ARCH", "SHAPE"))
    ap.add_argument("--largest", type=int, default=12)
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --cell: the 2 x 16 x 16 mesh")
    ap.add_argument("--optimized", action="store_true",
                    help="with --cell: launch.dryrun --optimized's flags")
    ap.add_argument("--exp", metavar="NAME",
                    help="a launch.perf experiment's cell, mesh and flags")
    ap.add_argument("--out", default="",
                    help="also write the sweep's lines to this JSON file")
    ap.add_argument("--table", metavar="RESULTS",
                    help="print a launch.dryrun --out file as a markdown "
                         "table, one row a cell, and stop")
    ap.add_argument("--where", action="store_true",
                    help="name each unsharded op's call site")
    args = ap.parse_args(argv)
    if args.table:
        table(args.table)
        return
    print(json.dumps({"torch": torch.__version__}), flush=True)
    if args.where:
        D.ReplicateFallback = WhereFallback
    if args.exp:
        from repro_torch.launch.perf import EXPERIMENTS
        [(arch, shape, mp, over)] = [e[1:] for e in EXPERIMENTS
                                     if e[0] == args.exp]
        one_cell(arch, shape, args.largest, args.where, mp, args.out, over)
    elif args.cell:
        from repro_torch.configs import SHAPES
        arch, shape = args.cell
        over = (D.optimized_overrides(arch, SHAPES[shape].kind)
                if args.optimized else None)
        one_cell(arch, shape, args.largest, args.where, args.multi_pod,
                 args.out, over)
    else:
        sweep(args.where, args.out)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The dry run's coverage and its largest buffers, on the host (no card).

Run from the repository root:

    python3 tools/dryrun_sweep.py                 # every arch's smoke config
    python3 tools/dryrun_sweep.py --cell gemma-2b train_4k --largest 12

Without ``--cell`` it traces each arch's smoke config (train, prefill and
decode at B 8, S 64) on the (4, 2) mesh of a fake world of 8 ranks, the
step ``launch/dryrun.py`` runs on production cells, and prints one JSON
line a cell: ok or the error, per-rank FLOPs, collectives by count, the
ops that ``ReplicateFallback`` had to unshard (they depend on the torch
version) and the peak bytes a rank.  With ``--cell ARCH SHAPE`` it runs
that production cell (``dryrun.run_cell``, 16 x 16 of a fake world of 512)
and prints its record and the ``--largest`` buffers live at its peak, by
the op that made them, their local shape and dtype.  Every figure is a
count on a fake world, not a time.  A full-width cell needs the memory of
the card machine's host for its bookkeeping, not for tensors (the local
tensors are "meta").
"""
from __future__ import annotations

import argparse
import collections
import json
import os
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


def sweep() -> None:
    from torch.distributed.device_mesh import init_device_mesh
    D.fake_world(8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    for arch in sorted(ARCHS):
        for kind in ("train", "prefill", "decode"):
            cfg = D._pick_cfg(smoke_config(arch), kind, {})
            t0 = time.perf_counter()
            try:
                rec = D.trace_step(cfg, ShapeConfig("t", 64, 8, kind), mesh,
                                   tc=TrainConfig() if kind == "train"
                                   else None)
                line = {"ok": True, "flops_per_device":
                        rec["flops_per_device"],
                        "collectives": {k: v["count"] for k, v in
                                        rec["collectives"].items()},
                        "replicated_ops": rec["replicated_ops"],
                        "peak_bytes": rec["peak_bytes"]}
            except Exception as e:  # noqa: BLE001 — report and go on
                line = {"ok": False, "error": f"{type(e).__name__}: "
                        f"{str(e)[-300:]}", "at": [
                            f"{f.filename.split('/')[-1]}:{f.lineno}"
                            for f in traceback.extract_tb(e.__traceback__)
                            if "repro_torch" in f.filename][-3:]}
            print(json.dumps({"arch": arch, "kind": kind, "s": round(
                time.perf_counter() - t0, 1), **line}), flush=True)


def one_cell(arch: str, shape: str, largest: int) -> None:
    D.Census = LargestCensus
    rec = D.run_cell(arch, shape)
    print(json.dumps(rec), flush=True)
    live, top = LargestCensus.made[-1].at_peak
    print(json.dumps({"live_at_peak_bytes": live}))
    for (op, shp, dtype), nb in top[:largest]:
        print(json.dumps({"bytes": nb, "op": op, "local_shape": shp,
                          "dtype": dtype}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs=2, metavar=("ARCH", "SHAPE"))
    ap.add_argument("--largest", type=int, default=12)
    args = ap.parse_args()
    print(json.dumps({"torch": torch.__version__}), flush=True)
    if args.cell:
        one_cell(*args.cell, args.largest)
    else:
        sweep()


if __name__ == "__main__":
    main()

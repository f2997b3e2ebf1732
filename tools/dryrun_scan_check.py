#!/usr/bin/env python3
"""A production cell's dry-run record with its recurrences traced once
against the same cell traced step by step.

Run from the repository root (a full-width cell: on the card machine's
host, whose memory the bookkeeping needs; no card is used):

    python3 tools/dryrun_scan_check.py --arch rwkv6-3b --shape train_4k \\
        --seq 256 [--multi-pod] [--out check.json]

``--seq`` cuts the cell's sequence (the step-by-step trace of rwkv6's
WKV recurrence takes about 0.6 s a position at full width); the widths,
depth, batch, mesh and sharding are the production cell's
(``launch.dryrun.lower_cell``).  It traces the cell twice on the 16 x 16
(or 2 x 16 x 16) mesh of a fake world of 512: with ``models.common.scan``
as it is, then with ``common._ONCE_MIN`` set past every S so that every
recurrence runs as the loop.  It prints one JSON line: both records'
FLOPs, bytes accessed, collectives, fallbacks, argument, output and temp
bytes and ``lower_s``, and which keys differ (``temp_bytes`` as a
relative difference).  Every figure is a count on a fake world, not a
time, except ``lower_s`` (host seconds).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

KEYS = ("flops_per_device", "bytes_accessed_per_device", "collectives",
        "replicated_ops", "argument_bytes", "output_bytes")


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.models import common, sharding
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cfg, shape, mesh, tc = D.lower_cell(args.arch, args.shape,
                                        multi_pod=args.multi_pod)
    shape = dataclasses.replace(shape, seq_len=args.seq)
    recs = {}
    try:
        for mode, once_min in (("once", common._ONCE_MIN),
                               ("step_by_step", 1 << 62)):
            common._ONCE_MIN = once_min
            recs[mode] = D.trace_step(cfg, shape, mesh, tc=tc)
    finally:
        sharding.set_ep2d(False)
    once, loop = recs["once"], recs["step_by_step"]
    row = {"arch": args.arch, "shape": args.shape, "seq": args.seq,
           "batch": shape.global_batch, "mesh": D._mesh_name(args.multi_pod),
           "differ": [k for k in KEYS if once[k] != loop[k]],
           "temp_rel_diff": (once["temp_bytes"] - loop["temp_bytes"])
           / loop["temp_bytes"],
           **{mode: {k: r[k] for k in (*KEYS, "temp_bytes", "lower_s")}
              for mode, r in recs.items()}}
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

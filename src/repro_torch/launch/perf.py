"""Perf hillclimb runner: run named optimization experiments on the three
chosen cells through the dry run on a fake world (``launch/dryrun.py``)
and append the records (with overrides recorded) to a JSON, as
``repro/launch/perf.py``.

Each experiment is hypothesis -> override set; the before row is the
baseline record of the dry run's results.  The ``ep2d`` knob is
``models/sharding.py``'s ``set_ep2d``, which ``run_cell`` applies.  The
records are a fake world's counts, not times.

Usage:
  python -m repro_torch.launch.perf [--exp NAME ...] [--out perf_results.json]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

# (name, arch, shape, multi_pod, overrides)
EXPERIMENTS = [
    # Cell A: deepseek train — collective-bound (FSDP gathers 675B of
    # expert weight per step).  A1: 2-D expert parallelism.
    ("A1_ep2d", "deepseek-v3-671b", "train_4k", True, {"ep2d": True}),
    # A2: + chunked CE (kill the (B,S,V) f32 logits peak; also MTP head)
    ("A2_ep2d_cechunk", "deepseek-v3-671b", "train_4k", True,
     {"ep2d": True, "ce_chunk": 512}),
    # A3: + bf16-dots remat policy instead of full remat (trade a little
    # activation memory for 25% fewer recompute FLOPs)
    ("A3_ep2d_cechunk_dots", "deepseek-v3-671b", "train_4k", True,
     {"ep2d": True, "ce_chunk": 512, "remat": "dots"}),
    # single-pod variants for the roofline table
    ("A2_sp", "deepseek-v3-671b", "train_4k", False,
     {"ep2d": True, "ce_chunk": 512}),
    # A4: + precise factored-stat sharding (shardspecs fix) and
    # momentum-free adafactor (Shazeer-Stern): less optimizer state a rank
    ("A4_ep2d_cechunk_nomom", "deepseek-v3-671b", "train_4k", True,
     {"ep2d": True, "ce_chunk": 512, "momentum": False}),
    ("A4_sp", "deepseek-v3-671b", "train_4k", False,
     {"ep2d": True, "ce_chunk": 512, "momentum": False}),
    # A5: + DeepSeek group-limited routing (8 groups, top-4): dispatch
    # traffic confined to half the mesh -> a2a per-link bytes halve
    ("A5_ep2d_groups", "deepseek-v3-671b", "train_4k", True,
     {"ep2d": True, "ce_chunk": 512, "momentum": False,
      "route_groups": 8, "route_top_groups": 4}),

    # Cell B: whisper decode — memory-heavy because its 20 KV heads
    # can't shard over the 16-way model axis.  B1: context-shard the cache
    # over `model` (shardspecs rule) — already active, re-measure;
    # B2: + vocab padding so the 51866-row embed/logits TP-shards.
    ("B1_ctx_shard", "whisper-large-v3", "decode_32k", False, {}),
    ("B2_ctx_vpad", "whisper-large-v3", "decode_32k", False,
     {"vocab_pad": 256}),

    # Cell C: internvl prefill — its peak is replicated fat-vocab
    # logits (151655 unshardable).  C1: vocab padding.
    ("C1_vpad", "internvl2-1b", "prefill_32k", False, {"vocab_pad": 256}),
    # C2: + last-token-only logits would be serving-specific; instead
    # measure the train cell with chunked CE (same logits pressure).
    ("C2_train_cechunk", "internvl2-1b", "train_4k", False,
     {"ce_chunk": 512, "vocab_pad": 256}),

    # B3: head padding (20 -> 32 heads, padded heads masked so the arch
    # function is exactly preserved): attention/KV shard 16-way instead of
    # replicating; applies to MHA archs (whisper)
    ("B3_head_pad", "whisper-large-v3", "decode_32k", False,
     {"vocab_pad": 256, "head_pad": 32}),
    ("B3_train", "whisper-large-v3", "train_4k", False,
     {"vocab_pad": 256, "head_pad": 32}),
]


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", nargs="*", default=None)
    ap.add_argument("--out", default="perf_results.json")
    args = ap.parse_args(argv)

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {r["exp"] for r in results if r.get("ok")}

    for name, arch, shape, mp, over in EXPERIMENTS:
        if args.exp and name not in args.exp:
            continue
        if name in done:
            print(f"[skip] {name} (cached)")
            continue
        print(f"[perf] {name}: {arch} {shape} "
              f"{'2x16x16' if mp else '16x16'} {over}", flush=True)
        try:
            rec = run_cell(arch, shape, multi_pod=mp, overrides=over)
            rec["exp"] = name
            print(f"  ok: flops/dev={rec['flops_per_device']:.3e} "
                  f"peak={rec['peak_bytes']/2**30:.2f}GiB "
                  f"lower={rec['lower_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001
            rec = {"exp": name, "arch": arch, "shape": shape, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAIL: {rec['error']}", flush=True)
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

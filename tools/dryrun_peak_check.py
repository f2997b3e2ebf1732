#!/usr/bin/env python3
"""The dry run's peak against the card's, for the same train step.

Run from the repository root on a machine with a CUDA card:

    python3 tools/dryrun_peak_check.py [--out peaks.json]

For each cell (rwkv6-3b's smoke config at B 8, S 256; gemma-2b at its
published config, B 2, S 1,024: the shape chip_smoke's ``train-gemma``
trains), both with the dry run's train config (``remat="full"``,
``seq_shard``), AdamW and float32 params:

* census: ``launch.dryrun.trace_step`` on a one-rank mesh of a fake world
  of 1 ("meta" tensors on the host): ``temp_bytes``, the most storage the
  step held live beyond its arguments, counted as tensors are made and
  freed;
* card: the same step (``build_train_step(donate=True)``) on real tensors
  on the card, after one warm-up step: ``torch.cuda.max_memory_allocated``
  after ``reset_peak_memory_stats``, less what was allocated when the step
  began (its arguments and the libraries' workspaces).

It prints one JSON line a cell with both, their ratio and the arguments'
bytes on each side, then the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.  It exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: (arch, smoke config?, S, B)
CELLS = (("rwkv6-3b", True, 256, 8), ("gemma-2b", False, 1024, 2))


def _cell(arch: str, smoke: bool, S: int, B: int):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun as D
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    return (D._pick_cfg(cfg, "train", {}), ShapeConfig("t", S, B, "train"),
            TrainConfig(warmup_steps=1, total_steps=4))


def census_side(cfg, shape, tc) -> dict:
    """The dry run's record of the step on a one-rank mesh of a fake
    world of 1, float32 params."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import dryrun as D
    D.fake_world(1)
    try:
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.long),
                          mesh_dim_names=("data", "model"))
        return D.trace_step(cfg, shape, mesh, tc=tc,
                            param_dtype=torch.float32)
    finally:
        dist.destroy_process_group()


def card_side(cfg, shape, tc) -> dict:
    """The step on the card: the peak it allocates beyond what was
    allocated when it began, after one warm-up step."""
    import torch
    from repro_torch.data.tokens import SyntheticCorpus, make_batch
    from repro_torch.train import steps as S
    dev = "cuda"
    state = S.init_state(cfg, tc, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, device=dev)
    step = S.build_train_step(cfg, tc, donate=True)
    corpus = SyntheticCorpus(cfg.vocab, seed=tc.seed)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(
        cfg, shape, step=0, corpus=corpus, device=dev).items()}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    arg_bytes = sum(t.untyped_storage().nbytes() for t in
                    torch.utils._pytree.tree_leaves((state, batch))
                    if isinstance(t, torch.Tensor))
    began = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    del state, batch, step
    torch.cuda.empty_cache()
    return {"argument_bytes": arg_bytes, "allocated_at_start": began,
            "temp_bytes": peak - began, "loss": loss}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dryrun_peak_check: needs a CUDA card", file=sys.stderr)
        return 1
    rows = []
    for arch, smoke, S, B in CELLS:
        cfg, shape, tc = _cell(arch, smoke, S, B)
        census = census_side(cfg, shape, tc)
        card = card_side(cfg, shape, tc)
        row = {"arch": arch + (" (smoke)" if smoke else ""), "S": S, "B": B,
               "remat": cfg.remat, "census_temp_bytes": census["temp_bytes"],
               "card_temp_bytes": card["temp_bytes"],
               "census_over_card": census["temp_bytes"] / card["temp_bytes"],
               "census_argument_bytes": census["argument_bytes"],
               "card_argument_bytes": card["argument_bytes"],
               "card_allocated_at_start": card["allocated_at_start"],
               "census_lower_s": census["lower_s"], "card_loss": card["loss"],
               "device": torch.cuda.get_device_name(0)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cells": rows, "nvidia_smi": smi.stdout.strip()}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher: the command line over ``train.loop.train``, as
``repro/launch/train.py``.

It trains on one card (``--device cuda``, the default; RuntimeError when
there is none) or on the CPU (``--device cpu``), in a world of one rank
that it brings up itself when no process group exists (no
``MASTER_ADDR`` needed).  The host mesh of one rank is never set active,
so the model's sharding hints stay the identity, as the reference's
launcher leaves a one-device mesh unset.  A world of more ranks is
refused: this launcher does not distribute the loop's state (the sharded
step is what ``launch/dryrun.py`` traces).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --steps 100 --batch 8 --seq 128 [--smoke] [--ckpt-dir DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --smoke --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.loop import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="TP width of the host mesh")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-step data deadline in seconds (straggler)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    own_world = not dist.is_initialized()
    mesh = make_host_mesh(model=args.model_axis, device_type=args.device)
    try:
        if mesh.size() > 1:
            raise SystemExit(f"a world of {mesh.size()} ranks: this "
                             "launcher trains on one rank")
        tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                         ckpt_dir=args.ckpt_dir,
                         compress_grads=args.compress_grads)
        shape = ShapeConfig("cli", args.seq, args.batch, "train")
        state, hist = train(cfg, tc, shape, step_deadline_s=args.deadline,
                            device=args.device)
        name = (torch.cuda.get_device_name(0) if args.device == "cuda"
                else "cpu")
        print(f"[device] {args.device}: {name}")
        print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps "
              f"on {mesh.size()} device(s)")
    finally:
        if own_world:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

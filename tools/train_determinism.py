#!/usr/bin/env python3
"""The training step's deterministic route on one NVIDIA GPU: does a step
repeat bit for bit, which ops ``torch.use_deterministic_algorithms``
refuses, and what the route costs.

Run from the repository root:

    python3 tools/train_determinism.py

The port's backward adds repeated rows in a fixed order by construction:
the token lookup is ``F.embedding`` (its backward sorts the tokens) and
the moe dispatch repeats the tokens K times (its backward sums the copies
in order), where an indexing backward (``embed[tokens]``,
``x.index_select(0, tok)``) adds by atomics.  This script

* repeats ``value_and_grad`` three times for each of the ten smoke
  configs at B 4, S 256 on the card, and reports whether every gradient
  leaf repeats bit for bit; then runs it once more under
  ``torch.use_deterministic_algorithms(True)`` and reports whether that
  raises (the op named) or gives the same bits;
* times gemma-2b's full-width ``value_and_grad`` (B 2, S 1,024, f32) by
  CUDA events, in turns with the deterministic mode off and on;
* times the two routes' backward at gemma-2b's lookup shape (2,048
  tokens into a 256,000 × 2,048 table) and at phi3.5-moe's dispatch shape
  (2,048 tokens, K 2, d 4,096): the fixed-order op against the indexing
  one, and whether the indexing one repeats bit for bit.

It sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts (the
deterministic mode needs it), prints the card's name and power limit
first and one JSON line a measurement, and exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def log(what: str, **fields) -> None:
    print(f"[{what}] " + json.dumps(fields, default=str), flush=True)


def leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def events_ms(torch, fn, reps: int = 1):
    """(last fn(), stream ms a call by CUDA events over reps calls)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def smoke_repeats(torch):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    from repro_torch.train import steps as S
    for name in sorted(configs.ARCHS):
        cfg = configs.smoke_config(name)
        seq = 256 + (cfg.n_patches if cfg.family == "vlm" else 0)
        batch = make_batch(cfg, ShapeConfig("t", seq, 4, "train"),
                           device="cuda")
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        grads = [S.value_and_grad(params, cfg, batch)[1] for _ in range(3)]
        repeat = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                     zip(*(leaves(g) for g in grads)))
        torch.use_deterministic_algorithms(True)
        try:
            det = S.value_and_grad(params, cfg, batch)[1]
            mode = ("same bits" if all(torch.equal(a, b) for a, b in zip(
                leaves(det), leaves(grads[0]))) else "other bits")
        except RuntimeError as exc:
            mode = "raises: " + str(exc).splitlines()[0][:160]
        finally:
            torch.use_deterministic_algorithms(False)
        log("smoke-repeat", arch=name, repeats_bitwise=repeat,
            deterministic_mode=mode)


def gemma_step(torch):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    from repro_torch.train import steps as S
    cfg = configs.get_config("gemma-2b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = make_batch(cfg, ShapeConfig("t", 1024, 2, "train"),
                       device="cuda")
    S.value_and_grad(params, cfg, batch)                  # warm-up
    times = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        torch.use_deterministic_algorithms(mode == "on")
        try:
            _, ms = events_ms(torch, lambda: S.value_and_grad(
                params, cfg, batch))
        finally:
            torch.use_deterministic_algorithms(False)
        times[mode].append(ms)
    log("gemma-value-and-grad", batch=2, seq=1024, ms_by_mode=times)


def route_costs(torch):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    V, D, T = 256_000, 2048, 2048
    table = torch.randn(V, D, device="cuda", generator=gen) * 0.02
    tokens = torch.randint(0, V // 64, (T,), device="cuda", generator=gen)
    gout = torch.randn(T, D, device="cuda", generator=gen)

    def backward(lookup):
        w = table.detach().requires_grad_()
        return torch.autograd.grad(lookup(w), w, gout)[0]

    out = {}
    for name, lookup in (("F.embedding", lambda w: F.embedding(tokens, w)),
                         ("index", lambda w: w[tokens])):
        first, _ = events_ms(torch, lambda: backward(lookup))
        again, ms = events_ms(torch, lambda: backward(lookup), reps=10)
        out[name] = {"ms": ms, "repeats_bitwise": bool(torch.equal(first,
                                                                   again))}
    log("route-embedding-backward", vocab=V, d=D, tokens=T,
        distinct_tokens=int(torch.unique(tokens).numel()), routes=out)
    del table
    K, D = 2, 4096
    x = torch.randn(T, D, device="cuda", generator=gen)
    gk = torch.randn(K * T, D, device="cuda", generator=gen)
    tok = torch.arange(T, device="cuda").repeat(K)

    def dispatch_backward(gather):
        h = x.detach().requires_grad_()
        return torch.autograd.grad(gather(h), h, gk)[0]

    out = {}
    for name, gather in (("repeat", lambda h: h.repeat(K, 1)),
                         ("index_select", lambda h: h.index_select(0, tok))):
        first, _ = events_ms(torch, lambda: dispatch_backward(gather))
        again, ms = events_ms(torch, lambda: dispatch_backward(gather),
                              reps=10)
        out[name] = {"ms": ms, "repeats_bitwise": bool(torch.equal(first,
                                                                   again))}
    log("route-dispatch-backward", tokens=T, top_k=K, d=D, routes=out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_determinism: needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    log("environment", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        cublas_workspace_config=os.environ["CUBLAS_WORKSPACE_CONFIG"])
    smoke_repeats(torch)
    gemma_step(torch)
    route_costs(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The moe families' single-card results, to hold two trees bit for bit.

For phi3.5-moe and deepseek-v3 (smoke configs; phi3.5-moe with drops and
under ``remat="full"``, deepseek-v3 with group-limited routing and in
bfloat16 too) on one device: ``forward`` (logits, aux, the taps' router
logits), ``steps.value_and_grad`` (loss and every gradient), ``prefill``
then four ``decode_step``s, and ``run_probes``' router traces.  Every
result is kept as its raw bits.

  python3 tools/moe_bits_check.py --src SRC --device cpu --out a.npz
  python3 tools/moe_bits_check.py --compare a.npz b.npz

``--src`` is the ``src`` directory of the tree to run (a parent unpacked
with ``git archive`` under ``build/``, or this one); ``--compare`` prints
one line a result that differs and exits 1 if any does.
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "phi": ("phi3.5-moe-42b-a6.6b", {}),
    "phi_drops": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}),
    "phi_remat": ("phi3.5-moe-42b-a6.6b", {"remat": "full"}),
    "dsv3": ("deepseek-v3-671b", {}),
    "dsv3_groups": ("deepseek-v3-671b", {"route_groups": 2,
                                         "route_top_groups": 1, "top_k": 3}),
}


def _bits(t) -> np.ndarray:
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.is_floating_point():
        return t.contiguous().view(torch.int32 if t.element_size() == 4
                                   else torch.int64).numpy()
    return t.numpy()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", v


def run(device: str) -> dict:
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    from repro_torch.monitor.probes import default_probes, run_probes
    from repro_torch.train import steps as S
    out = {}
    for name, (arch, over) in CASES.items():
        for dtype in ((torch.float32, torch.bfloat16) if name == "dsv3"
                      else (torch.float32,)):
            tag = f"{name}/{str(dtype).removeprefix('torch.')}"
            cfg = smoke_config(arch).replace(**over)
            params = M.init_params(
                cfg, torch.Generator(device=device).manual_seed(0),
                dtype=dtype, device=device)
            batch = make_batch(cfg, ShapeConfig("t", 32, 4, "train"),
                               dtype=dtype, device=device)
            logits, aux, taps = M.forward(params, cfg, batch, taps=True)
            out[f"{tag}/logits"] = _bits(logits)
            out[f"{tag}/aux"] = _bits(aux)
            out[f"{tag}/router"] = _bits(taps["router_logits"])
            metrics, grads = S.value_and_grad(params, cfg, batch)
            for k, v in metrics.items():
                out[f"{tag}/metric/{k}"] = _bits(v)
            for path, g in _leaves(grads):
                out[f"{tag}/grad/{path}"] = _bits(g)
            if "remat" in over:
                continue
            prompt = {"tokens": batch["tokens"][:, :24]}
            lg, cache, pos = M.prefill(params, cfg, prompt, 32)
            out[f"{tag}/prefill"] = _bits(lg)
            tok = torch.as_tensor(batch["tokens"][:, 24:25], device=device)
            for i in range(4):
                lg, cache = M.decode_step(params, cfg, tok, cache, pos + i)
                out[f"{tag}/decode{i}"] = _bits(lg)
                tok = lg.argmax(-1)
            if dtype == torch.float32:
                traces = run_probes(cfg, default_probes(cfg), params, batch,
                                    seed=0)
                for k, tr in traces.items():
                    for f, v in vars(tr).items():
                        if isinstance(v, torch.Tensor):
                            out[f"{tag}/probe/{k}/{f}"] = _bits(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (np.load(p) for p in args.compare)
        bad = sorted(k for k in set(a.files) | set(b.files)
                     if k not in a.files or k not in b.files
                     or not np.array_equal(a[k], b[k]))
        for k in bad:
            print(f"differs: {k}")
        print(f"moe-bits: {len(a.files)} results, {len(bad)} differ")
        return 1 if bad else 0
    sys.path.insert(0, os.path.abspath(args.src))
    out = run(args.device)
    np.savez(args.out, **out)
    import repro_torch
    print(f"moe-bits: {len(out)} results from "
          f"{os.path.dirname(os.path.dirname(repro_torch.__file__))} on "
          f"{args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The model families' single-card results, to hold two trees bit for bit.

Smoke configs on one device.  The moe family: phi3.5-moe (plain, with
drops, under ``remat="full"`` and ``"dots"``) and deepseek-v3 (plain and
with group-limited routing, in bfloat16 too).  The other families, each
under ``remat="full"`` and ``"dots"``: gemma-2b (dense), internvl2-1b
(vlm), rwkv6-3b (ssm), zamba2-2.7b (hybrid) and whisper-large-v3 (audio).
For each case: ``forward`` (logits, aux, the taps' layer outputs and, for
moe, router logits) and ``steps.value_and_grad`` (loss and every
gradient); the cases marked to serve also ``prefill`` then four
``decode_step``s and, in f32, ``run_probes``' traces; those in
``TRAIN_STEP`` one train step (Adafactor for deepseek-v3, AdamW for
gemma-2b): the new params and optimizer state.  Every result is kept as
its raw bits.

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

#: name -> (arch, config overrides, whether prefill, decode and the probes
#: run too)
CASES = {
    "phi": ("phi3.5-moe-42b-a6.6b", {}, True),
    "phi_drops": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}, True),
    "phi_remat": ("phi3.5-moe-42b-a6.6b", {"remat": "full"}, False),
    "phi_dots": ("phi3.5-moe-42b-a6.6b", {"remat": "dots"}, False),
    "dsv3": ("deepseek-v3-671b", {}, True),
    "dsv3_groups": ("deepseek-v3-671b", {"route_groups": 2,
                                         "route_top_groups": 1, "top_k": 3},
                    True),
    **{f"{name}_{remat}": (arch, {"remat": remat}, remat == "full")
       for name, arch in (("gemma", "gemma-2b"), ("internvl", "internvl2-1b"),
                          ("rwkv", "rwkv6-3b"), ("zamba", "zamba2-2.7b"),
                          ("whisper", "whisper-large-v3"))
       for remat in ("full", "dots")},
}

#: cases that also take one train step (``build_train_step``) with this
#: optimizer: the new params and the optimizer state
TRAIN_STEP = {"dsv3": "adafactor", "gemma_full": "adamw"}


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
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    from repro_torch.monitor.probes import default_probes, run_probes
    from repro_torch.train import steps as S
    out = {}
    for name, (arch, over, serve) in CASES.items():
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
            out[f"{tag}/layer_out"] = _bits(taps["layer_out"])
            if "router_logits" in taps:
                out[f"{tag}/router"] = _bits(taps["router_logits"])
            metrics, grads = S.value_and_grad(params, cfg, batch)
            for k, v in metrics.items():
                out[f"{tag}/metric/{k}"] = _bits(v)
            for path, g in _leaves(grads):
                out[f"{tag}/grad/{path}"] = _bits(g)
            if name in TRAIN_STEP:
                tc = TrainConfig(optimizer=TRAIN_STEP[name])
                state = S.init_state(
                    cfg, tc, torch.Generator(device=device).manual_seed(1),
                    dtype, device=device)
                state, _ = S.build_train_step(cfg, tc)(state, batch)
                for path, t in _leaves({"params": state.params,
                                        "opt": state.opt._asdict()}):
                    for i, leaf in enumerate(t if isinstance(t, tuple)
                                             else (t,)):
                        out[f"{tag}/step/{path}/{i}"] = _bits(leaf)
            if not serve:
                continue
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            prompt["tokens"] = batch["tokens"][:, :24]
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
        print(f"model-bits: {len(a.files)} results, {len(bad)} differ")
        return 1 if bad else 0
    sys.path.insert(0, os.path.abspath(args.src))
    out = run(args.device)
    np.savez(args.out, **out)
    import repro_torch
    print(f"model-bits: {len(out)} results from "
          f"{os.path.dirname(os.path.dirname(repro_torch.__file__))} on "
          f"{args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

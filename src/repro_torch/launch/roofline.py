"""Roofline analysis: three terms per (arch x shape x mesh) cell, as
``repro/launch/roofline.py``, answered for the H100.

Sources of truth and their roles:

* the dry run's census (``launch/dryrun.py``) — per-rank peak bytes
  (proves fit) and the collective pattern, counted on a fake world;
* **the analytic workload model (this file)** — FLOPs, HBM bytes and
  collective bytes per step from the architecture, shape and sharding
  scheme, with the formulas documented inline.  These are the roofline
  numerators; they are the reference's, to the last bit.

Hardware constants: one NVIDIA H100 SXM (the data sheet's dense rates at
its 700 W limit).  The collective term's link is an assumption: NVLink
(450 GB/s each way) joins the 8 cards of one host only, and a 16 x 16 or
2 x 16 x 16 world spans 32 or 64 hosts, so each axis's ring crosses the
network; ``NET_BW`` takes one 400 Gb/s (50 GB/s) network port a card,
which is this port's assumption, not a measurement.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M

PEAK_FLOPS_BF16 = 989e12   # FLOP/s a card, bf16 dense tensor cores
PEAK_FLOPS_F32 = 67e12     # FLOP/s a card, f32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s a card (HBM3, 80 GB)
NET_BW = 50e9              # bytes/s a card across hosts (assumed 400 Gb/s)
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------- param census ----

def param_census(cfg: ModelConfig) -> dict:
    """Exact parameter counts from the real init tree (on "meta": shapes
    only, nothing drawn)."""
    tree = M.init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                         device="meta")
    total = expert = embed = 0
    for path, leaf in _paths(tree):
        n = leaf.numel()
        total += n
        leafname = path.split("/")[-1]
        if leafname.startswith("e_"):
            expert += n
        if leafname in ("embed", "lm_head"):
            embed += n
    routed_frac = cfg.top_k / cfg.n_experts if cfg.n_experts else 1.0
    active = total - int(expert * (1.0 - routed_frac))
    return {"total": total, "active": active, "expert": expert,
            "embed": embed, "active_nonembed": active - embed}


# ---------------------------------------------------- workload model -----

def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.n_layers + cfg.n_enc_layers  # + cross handled separately
    return cfg.n_layers


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig, *,
                   remat: bool = True) -> dict:
    """Global FLOPs per step.

    train: matmul params contribute 2 (fwd) + 4 (bwd) + 2 (remat recompute)
    FLOPs per param per token; quadratic attention adds
    2*B*S^2*H*hd per layer fwd (causal halves the S^2 matmuls).
    decode: 2 FLOPs per active matmul param per token + KV-cache reads.
    """
    c = param_census(cfg)
    B, S = shape.global_batch, shape.seq_len
    Hhd = cfg.n_heads * cfg.head_dim
    if cfg.use_mla:
        Hhd = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    La = _attn_layers(cfg)

    if shape.kind == "decode":
        tokens = B
        matmul = 2.0 * c["active_nonembed"] + 2.0 * cfg.d_model * cfg.vocab
        flops = matmul * tokens
        if cfg.use_mla:  # absorbed decode: latent-space scores + context
            lat = cfg.kv_lora_rank + cfg.qk_rope_dim
            flops += 4.0 * B * cfg.n_heads * lat * S * La
        else:
            flops += 4.0 * B * cfg.n_kv_heads * cfg.head_dim * S * La \
                * (cfg.n_heads // max(cfg.n_kv_heads, 1))
        model_flops = 2.0 * c["active"] * tokens
        return {"total": flops, "model": model_flops, "tokens": tokens}

    tokens = B * S
    if shape.kind == "train":
        f = 8.0 if remat else 6.0    # per-param-per-token matmul factor
        tf = 4.0 if remat else 3.0   # multiples of one fwd pass
    else:                            # prefill: forward only
        f, tf = 2.0, 1.0
    matmul = c["active_nonembed"] + cfg.d_model * cfg.vocab
    flops = f * matmul * tokens

    def quad_term(Sq, Sk, layers, causal):
        fwd = 4.0 * B * Sq * Sk * Hhd * (0.5 if causal else 1.0)
        return tf * fwd * layers

    if cfg.family == "audio":
        quad = (quad_term(cfg.enc_seq, cfg.enc_seq, cfg.n_enc_layers, False)
                + quad_term(S, S, cfg.n_layers, True)
                + quad_term(S, cfg.enc_seq, cfg.n_layers, False))
    elif cfg.family == "ssm":
        # rwkv recurrence: ~6 flops per (head-channel x N) per token
        quad = tf / 3.0 * 6.0 * tokens * cfg.d_model * cfg.rwkv_head_dim \
            * cfg.n_layers
    else:
        quad = quad_term(S, S, La, True)
        if cfg.family == "hybrid":
            inner, P = cfg.ssm_expand * cfg.d_model, cfg.ssm_head_dim
            N, Lc = cfg.ssm_state, cfg.ssm_chunk
            Hm = inner // P
            n_mamba = cfg.n_layers - La
            # SSD fwd: intra-chunk (Lc*N + Lc*Hm*P) + state in/out (8*N*Hm*P)
            per_tok = 2 * (Lc * N + Lc * Hm * P) + 8 * N * Hm * P
            quad += tf / 3.0 * per_tok * tokens * n_mamba
    flops += quad
    model_flops = (6.0 if shape.kind == "train" else 2.0) * c["active"] * tokens
    return {"total": flops, "model": model_flops, "tokens": tokens}


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict,
                       *, remat: bool = True, ctx_shard: bool = True) -> float:
    """Per-device HBM traffic per step (documented approximation).

    train: gathered weights stream through HBM twice (fwd + bwd recompute
    pass), optimizer state read+write in f32-equivalents, activations ~12
    passes of the (B_loc, S_loc, D) residual per layer.
    decode: active weight shard once + local KV/state cache once.
    """
    c = param_census(cfg)
    devs = 1
    for v in mesh_shape.values():
        devs *= v
    model = mesh_shape.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    L = cfg.n_layers

    if shape.kind == "decode":
        wbytes = 2 * c["active"] / devs * max(model, 1)  # TP shard per device
        cache = M.init_cache(cfg, B, S, torch.bfloat16, device="meta")
        cbytes = sum(t.numel() * t.element_size()
                     for t in _leaves(cache)) / devs
        if cfg.n_kv_heads % model != 0 and not ctx_shard:
            # heads can't split over `model` and the cache isn't context-
            # sharded: every model rank re-reads a replicated cache
            cbytes *= model
        return wbytes + cbytes

    train = shape.kind == "train"
    wbytes = 2 * c["total"] / model * (2 if train else 1)  # gathered passes
    opt = 12 * c["total"] / devs if train else 0.0  # m,v,p f32 read+write
    b_loc = max(B // (devs // model), 1)
    s_loc = S / model if cfg.seq_shard else S
    act = (12 if train else 6) * L * b_loc * s_loc * D * 2
    return wbytes + opt + act


def analytic_collective_bytes(cfg: ModelConfig, shape: ShapeConfig,
                              mesh_shape: dict, *,
                              ep2d: bool = False) -> dict:
    """Per-device collective bytes per step, by purpose.

    ep2d: experts distributed over model x data (no FSDP gather of expert
    weights; tokens move via all-to-all instead — which MoE dispatch does
    in *both* modes, so the a2a term is always counted).
    """
    c = param_census(cfg)
    d = mesh_shape.get("data", 1)
    m = mesh_shape.get("model", 1)
    p = mesh_shape.get("pod", 1)
    devs = d * m * p
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    dp = d * p

    if shape.kind == "decode":
        b_loc = max(B // dp, 1)
        tp = 2 * L * b_loc * D * 2               # per-layer TP all-reduce
        a2a = (2 * L * cfg.top_k * b_loc * D * 2) if cfg.n_experts else 0.0
        return {"tp": tp, "fsdp": 0.0, "dp_grad": 0.0, "a2a": a2a,
                "total": tp + a2a}

    train = shape.kind == "train"
    passes = 3 if train else 1
    # FSDP: gather weights over `data` (fwd [+ bwd recompute]), RS grads.
    # Under 2-D EP the expert stack is never gathered.
    gathered = c["total"] - (c["expert"] if ep2d else 0)
    fsdp = passes * (2 * gathered / m) * (d - 1) / d
    # DP gradient all-reduce over `pod`
    dp_grad = (2 * (2 * c["total"] / (m * d)) * (p - 1) / p) \
        if (p > 1 and train) else 0.0
    # TP activation collectives: ~4 per layer per pass of the local residual
    b_loc = max(B // dp, 1)
    tp = (8 if train else 4) * L * b_loc * S * D * 2 / m
    # MoE dispatch/combine all-to-all: top_k entries per token per layer,
    # each direction, every pass
    a2a = 0.0
    if cfg.n_experts:
        tok_per_dev = B * S / devs
        a2a = passes * 2 * L * cfg.top_k * tok_per_dev * D * 2
        if cfg.route_groups > 1:
            # group-limited routing confines dispatch to top_g/g of the
            # mesh; per-link traffic scales with the reachable fraction
            a2a *= cfg.route_top_groups / cfg.route_groups
    total = fsdp + dp_grad + tp + a2a
    return {"tp": tp, "fsdp": fsdp, "dp_grad": dp_grad, "a2a": a2a,
            "total": total}


# ------------------------------------------------------------ report -----

@dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    peak_gib: float
    hlo_collectives: dict
    note: str = ""


def analyze(rec: dict) -> Cell:
    """The three terms of one dry-run record: global FLOPs over the
    ranks at the peak of the record's ``param_dtype`` (bfloat16 when it
    has none, as the dry run), HBM bytes at ``HBM_BW``, collective bytes
    at ``NET_BW``.  ``hlo_collectives`` is the census's per-rank
    collectives (the reference's name for its HLO census)."""
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    mesh_shape = ({"pod": 2, "data": 16, "model": 16}
                  if rec["mesh"] == "2x16x16" else {"data": 16, "model": 16})
    devs = rec["n_devices"]
    over = dict(rec.get("overrides", {}))
    ep2d = over.pop("ep2d", False)
    over.pop("momentum", None)
    remat = over.get("remat", "full") != "none" and shape.kind == "train"
    if shape.kind == "train":
        cfg = cfg.replace(seq_shard=True)
    cfg = cfg.replace(**{k: v for k, v in over.items()
                         if hasattr(cfg, k)})
    fl = analytic_flops(cfg, shape, remat=remat)
    # baseline records predate the context-sharded cache rule; perf
    # records (tagged "exp") ran with it
    hbm = analytic_hbm_bytes(cfg, shape, mesh_shape, remat=remat,
                             ctx_shard="exp" in rec)
    coll = analytic_collective_bytes(cfg, shape, mesh_shape, ep2d=ep2d)
    compute_s = fl["total"] / devs / PEAK_FLOPS[rec.get("param_dtype",
                                                        "bfloat16")]
    memory_s = hbm / HBM_BW
    coll_s = coll["total"] / NET_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bn = max(terms, key=terms.get)
    return Cell(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bn,
        model_flops=fl["model"],
        useful_ratio=fl["model"] / fl["total"],
        peak_gib=rec.get("peak_bytes", 0) / 2**30,
        hlo_collectives=rec.get("collectives", {}),
    )


def markdown_table(records: list[dict]) -> str:
    rows = ["| arch | shape | mesh | compute_s | memory_s | collective_s | "
            "bottleneck | useful | peak GiB | collectives |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for rec in records:
        if not rec.get("ok"):
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
                        f"FAILED: {rec.get('error','?')} | | | | | | |")
            continue
        c = analyze(rec)
        hlo = ", ".join(f"{k.split('-')[0]}-{k.split('-')[1][:1]}x{v['count']}"
                        for k, v in sorted(c.hlo_collectives.items()))
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {c.compute_s:.3e} | "
            f"{c.memory_s:.3e} | {c.collective_s:.3e} | **{c.bottleneck}** | "
            f"{c.useful_ratio:.2f} | {c.peak_gib:.2f} | {hlo} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="dryrun_results.json")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        records = json.load(f)
    print(markdown_table(records))


if __name__ == "__main__":
    main()

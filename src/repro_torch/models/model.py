"""Model zoo assembly: init / forward / decode for every family.

One parameter dict + pure-function design, as ``repro/models/model.py``:

  init_params(cfg, generator, dtype, device)     -> params dict of tensors
  forward(params, cfg, batch)                    -> (logits, aux_loss)
  init_cache(cfg, batch, max_len, dtype, device) -> decode cache
  prefill(params, cfg, batch, max_len)           -> (logits, cache, pos)
  decode_step(params, cfg, tokens, cache, pos)   -> (logits, cache)
  params_from_numpy(tree, device, dtype)         -> the reference's weights

Families: ``dense`` and ``vlm`` (GQA blocks), ``moe`` (GQA or MLA, the
capacity-dispatched ``moe_ffn``, and DeepSeek-V3's MTP block), ``ssm``
(RWKV-6), ``hybrid`` (Mamba2 super-blocks around one shared attention
block, Zamba2) and ``audio`` (whisper's encoder–decoder over precomputed
frame embeddings).

Layers are *stacked* (a leading L axis on every leaf of
``params["layers"]``; (super-block, inner) for hybrid); the functions
walk them in a Python loop where the reference scans.  The tree, its leaf
names and shapes are the reference's, and ``init_params`` draws the
leaves in the reference's order (embed, lm_head unless tied, then each
subtree's leaves by sorted name) from one ``torch.Generator``; JAX's draws
cannot be reproduced in torch, so the weights differ and
``params_from_numpy`` carries the reference's own across.  Every function
runs on the params' device, its products in full f32
(``kernels.ref.full_f32``): no TF32, whatever the process set.

Decode positions are host integers.  The KV and latent caches are written
in place (``decode_step`` and ``prefill`` return them); the recurrent
states of ``ssm`` and ``hybrid`` are replaced by new tensors each step, in
the dtype the step computes them in, as the reference's scan returns them.

``cfg.remat`` rematerializes each layer body the reference scans (a layer;
a hybrid super-block; each encoder and decoder layer) when autograd records
the forward, as the reference's ``_maybe_remat``: ``"full"`` saves only
the body's inputs (``torch.utils.checkpoint``, non-reentrant), ``"dots"``
saves the outputs of its matrix products with no batch dimension and
recomputes the rest (a selective checkpoint), ``"none"`` saves everything.
The recomputation runs in the backward, so a caller that differentiates
runs the backward under ``full_f32`` too (``train/steps.py`` does).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import full_f32
from repro_torch.models.attention import (KVCache, MLACache, cross_block,
                                          gqa_block, mla_block)
from repro_torch.models import sharding
from repro_torch.models.common import (dense_init, rms_norm, rope_freqs,
                                       seq_whole)
from repro_torch.models.mamba2 import (MambaState, _dims, init_mamba_state,
                                       mamba_block)
from repro_torch.models.moe import dense_ffn, moe_ffn
from repro_torch.models.rwkv6 import RWKVState, init_rwkv_state, rwkv_block

# --------------------------------------------------------------- init ----


def _init_tree(generator: torch.Generator, spec: dict, dtype,
               device) -> dict:
    """spec: name -> (shape, scale|None|"zeros"|"ones"|callable); leaves
    drawn in sorted name order.  A callable gets (generator, shape,
    device) and returns an f32 tensor."""
    out = {}
    for name, (shape, scale) in sorted(spec.items()):
        if scale == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif scale == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif torch.device(device).type == "meta":   # shapes only, no draws
            out[name] = torch.empty(shape, dtype=dtype, device=device)
        elif callable(scale):
            out[name] = scale(generator, shape, device).to(dtype)
        else:
            out[name] = dense_init(generator, shape, scale, dtype, device)
    return out


def _attn_spec(cfg: ModelConfig, L: tuple[int, ...]) -> dict:
    D = cfg.d_model
    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {
            "wq_a": ((*L, D, cfg.q_lora_rank), None),
            "q_norm": ((*L, cfg.q_lora_rank), "zeros"),
            "wq_b": ((*L, cfg.q_lora_rank, cfg.n_heads * (dn + dr)), None),
            "wkv_a": ((*L, D, cfg.kv_lora_rank + dr), None),
            "kv_norm": ((*L, cfg.kv_lora_rank), "zeros"),
            "wkv_b": ((*L, cfg.kv_lora_rank, cfg.n_heads * (dn + dv)), None),
            "wo": ((*L, cfg.n_heads * dv, D), None),
        }
    return {
        "wq": ((*L, D, cfg.q_dim), None),
        "wk": ((*L, D, cfg.kv_dim), None),
        "wv": ((*L, D, cfg.kv_dim), None),
        "wo": ((*L, cfg.q_dim, D), None),
    }


def _ffn_spec(cfg: ModelConfig, L: tuple[int, ...], d_ff: int,
              prefix: str = "w") -> dict:
    D = cfg.d_model
    spec = {
        f"{prefix}_up": ((*L, D, d_ff), None),
        f"{prefix}_down": ((*L, d_ff, D), None),
    }
    if cfg.gated:
        spec[f"{prefix}_gate"] = ((*L, D, d_ff), None)
    return spec


def _moe_spec(cfg: ModelConfig, L: tuple[int, ...]) -> dict:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    spec = {
        "router": ((*L, D, E), 0.02),
        "e_up": ((*L, E, D, Fe), None),
        "e_down": ((*L, E, Fe, D), None),
    }
    if cfg.gated:
        spec["e_gate"] = ((*L, E, D, Fe), None)
    if cfg.n_shared_experts > 0:
        spec.update(_ffn_spec(cfg, L, Fe * cfg.n_shared_experts, prefix="s"))
    return spec


def _uniform(generator, shape, device, lo, hi):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(lo, hi, generator=generator)


def _a_init(generator, shape, device):
    return torch.log(_uniform(generator, shape, device, 1.0, 16.0))


def _dt_init(generator, shape, device):
    dt = torch.exp(_uniform(generator, shape, device, math.log(1e-3),
                            math.log(1e-1)))
    return dt + torch.log(-torch.expm1(-dt))  # inverse softplus


def _conv_init(generator, shape, device):
    return 0.1 * torch.randn(shape, generator=generator, device=device)


def _const(value: float):
    def init(generator, shape, device):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return init


def _mamba_spec(cfg: ModelConfig, L: tuple[int, ...]) -> dict:
    inner, H, P, N = _dims(cfg)
    D = cfg.d_model
    proj_out = 2 * inner + 2 * N + H
    return {
        "ln": ((*L, D), "zeros"),
        "in_proj": ((*L, D, proj_out), None),
        "conv": ((*L, 4, inner + 2 * N), _conv_init),
        "a_log": ((*L, H), _a_init),
        "dt_bias": ((*L, H), _dt_init),
        "skip_d": ((*L, H), "ones"),
        "norm": ((*L, inner), "zeros"),
        "out_proj": ((*L, inner, D), None),
    }


def _rwkv_spec(cfg: ModelConfig, L: tuple[int, ...]) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    N = cfg.rwkv_head_dim
    H = D // N
    half = _const(0.5)
    return {
        "ln1": ((*L, D), "zeros"), "ln2": ((*L, D), "zeros"),
        "mu_r": ((*L, D), half), "mu_k": ((*L, D), half),
        "mu_v": ((*L, D), half), "mu_w": ((*L, D), half),
        "mu_g": ((*L, D), half),
        "w_recv": ((*L, D, D), None), "w_key": ((*L, D, D), None),
        "w_val": ((*L, D, D), None), "w_gateproj": ((*L, D, D), None),
        "w0": ((*L, D), _const(-4.6)),
        "w_lora_a": ((*L, D, 64), 0.02), "w_lora_b": ((*L, 64, D), 0.02),
        "u": ((*L, H, N), 0.02),
        "ln_x": ((*L, D), "zeros"),
        "w_out": ((*L, D, D), None),
        "cm_mu_k": ((*L, D), half), "cm_mu_r": ((*L, D), half),
        "w_up": ((*L, D, F), None), "w_down": ((*L, F, D), None),
        "w_recv_cm": ((*L, D, D), None),
    }


def _block_spec(cfg: ModelConfig, L: tuple[int, ...],
                moe: bool = False) -> dict:
    spec = {"ln1": ((*L, cfg.d_model), "zeros"),
            "ln2": ((*L, cfg.d_model), "zeros")}
    spec.update(_attn_spec(cfg, L))
    if moe:
        spec.update(_moe_spec(cfg, L))
    else:
        spec.update(_ffn_spec(cfg, L, cfg.d_ff))
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                dtype=torch.float32, device="cuda") -> dict:
    """Random weights for ``cfg`` on ``device`` (``generator`` lives
    there; on "meta" nothing is drawn and the tree is shapes and dtypes
    only, the dry run's stand-in): ``embed`` (padded_vocab, d_model) at
    scale 0.02, ``final_norm``, ``lm_head`` unless tied, ``layers`` with stacked
    leaves, and the family's extras (``mtp_block``; ``shared_attn``;
    ``enc_layers`` and ``enc_final_norm``)."""
    D, V = cfg.d_model, cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": dense_init(generator, (V, D), 0.02, dtype, device),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (D, V), None, dtype,
                                       device)

    def tree(spec):
        return _init_tree(generator, spec, dtype, device)

    fam, L = cfg.family, (cfg.n_layers,)
    if fam in ("dense", "vlm"):
        params["layers"] = tree(_block_spec(cfg, L))
    elif fam == "moe":
        params["layers"] = tree(_block_spec(cfg, L, moe=True))
        if cfg.mtp:
            mtp = _block_spec(cfg, ())
            mtp["mtp_proj"] = ((2 * D, D), None)
            mtp["mtp_norm"] = ((D,), "zeros")
            params["mtp_block"] = tree(mtp)
    elif fam == "ssm":
        params["layers"] = tree(_rwkv_spec(cfg, L))
    elif fam == "hybrid":
        nsb = cfg.n_layers // cfg.attn_every
        params["layers"] = tree(_mamba_spec(cfg, (nsb, cfg.attn_every - 1)))
        params["shared_attn"] = tree(_block_spec(cfg, ()))
    elif fam == "audio":
        params["enc_layers"] = tree(_block_spec(cfg, (cfg.n_enc_layers,)))
        params["enc_final_norm"] = torch.zeros((D,), dtype=dtype,
                                               device=device)
        dec = _block_spec(cfg, L)
        dec.update({f"x_{k}": v for k, v in _attn_spec(cfg, L).items()})
        dec["ln_x_attn"] = ((cfg.n_layers, D), "zeros")
        params["layers"] = tree(dec)
    else:
        raise ValueError(f"unknown family {fam}")
    return params


def _leaf_tensor(x, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # ml_dtypes: numpy has no bf16
        t = torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.tensor(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, *, device="cuda", dtype=None):
    """The reference's params pytree with numpy leaves (e.g.
    ``jax.device_get(repro.models.model.init_params(...))``) as the port's
    dict of tensors on ``device``: the same keys and shapes, each leaf in
    its own dtype (bfloat16 included) or cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    return _leaf_tensor(tree, device, dtype)


# ------------------------------------------------------------ forward ----

#: The products ``"dots"`` saves: those with no batch dimension
#: (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``).  A
#: (B, S, D) @ (D, F) product runs as ``mm``; attention's ``einsum``s run
#: as ``bmm`` and are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig):
    """``run(body, *args)`` for one layer body under ``cfg.remat``; a plain
    call when autograd is not recording."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return lambda body, *args: body(*args)
    if cfg.remat == "full":
        return lambda body, *args: checkpoint(body, *args,
                                              use_reentrant=False)
    return lambda body, *args: checkpoint(
        body, *args, use_reentrant=False,
        context_fn=lambda: create_selective_checkpoint_contexts(
            _dots_policy))


def _layer(tree: dict, *idx) -> dict:
    """One layer's leaves (views) of a stacked subtree (the subtree's own
    leaves with no ``idx``), each FSDP shard gathered under a mesh."""
    return {k: sharding.gather_fsdp(v[idx] if idx else v)
            for k, v in tree.items()}


def _attn(p, h, cfg, cos, sin, cache=None, pos=0, causal=True):
    if cfg.use_mla:
        return mla_block(p, h, cfg, cos, sin, cache=cache, pos=pos)
    return gqa_block(p, h, cfg, cos, sin, causal=causal, cache=cache,
                     pos=pos)


def _dense_block(p, h, cfg, cos, sin, cache=None, pos=0, causal=True):
    a, new_cache = _attn(p, rms_norm(h, p["ln1"], cfg.norm_eps), cfg, cos,
                         sin, cache=cache, pos=pos, causal=causal)
    h = h + a
    h = h + dense_ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h, new_cache


def _moe_block(p, h, cfg, cos, sin, cache=None, pos=0, taps=False):
    """Returns (h, aux, cache, router logits or None)."""
    a, new_cache = _attn(p, rms_norm(h, p["ln1"], cfg.norm_eps), cfg, cos,
                         sin, cache=cache, pos=pos)
    h = h + a
    hn = rms_norm(h, p["ln2"], cfg.norm_eps)
    if taps:
        y, aux, logits = moe_ffn(p, hn, cfg, return_logits=True)
        return h + y, aux, new_cache, logits
    y, aux = moe_ffn(p, hn, cfg)
    return h + y, aux, new_cache, None


def _mamba_residual(lp, h, cfg, state=None, return_state=False):
    d, ns = mamba_block(lp, rms_norm(h, lp["ln"], cfg.norm_eps), cfg,
                        state=state, return_state=return_state)
    return h + d, ns


def _tokens(params, batch_tokens) -> torch.Tensor:
    return torch.as_tensor(batch_tokens,
                           device=params["embed"].device).long()


def _embed_tokens(params, cfg, tokens):
    # the lookup as F.embedding: its backward adds repeated tokens' rows in
    # a fixed order on the CPU and the card (an indexing backward adds them
    # by atomics on the CPU's threads).  On a vocab-sharded table the rows
    # are summed over the vocab shards at once (``settle``)
    h = sharding.settle(F.embedding(tokens,
                                    sharding.gather_fsdp(params["embed"])))
    if cfg.tie_embeddings:  # gemma-style input scaling
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def _lm_head(params, cfg, h):
    h = seq_whole(rms_norm(h, params["final_norm"], cfg.norm_eps))
    if cfg.tie_embeddings:
        logits = (h @ sharding.gather_fsdp(params["embed"]).T).float()
    else:
        logits = (h @ sharding.gather_fsdp(params["lm_head"])).float()
    if cfg.padded_vocab != cfg.vocab:   # mask padding rows out of softmax
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _rope_tables(cfg, positions):
    dim = cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    return rope_freqs(positions, dim, cfg.rope_theta)


def _positions(h, start: int, n: int):
    return torch.arange(start, start + n, device=h.device)


def _prompt(params, cfg, batch):
    """Embedded tokens, with the vlm patches prepended."""
    h = _embed_tokens(params, cfg, _tokens(params, batch["tokens"]))
    if cfg.family == "vlm":
        h = torch.cat([batch["patches"].to(device=h.device, dtype=h.dtype),
                       h], dim=1)
    return h


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            return_hidden: bool = False, taps: bool = False):
    """Full-sequence forward on the params' device.  Returns (logits
    (B,S,V) f32, aux_loss 0-d f32), or (final hidden states, aux) with
    ``return_hidden=True``.

    batch: ``tokens`` (B, S[-n_patches]) int (numpy or tensor); vlm adds
    ``patches`` (B, n_patches, D), prepended to the token embeddings and
    stripped after the stack; audio adds ``enc_frames`` (B, enc_seq, D);
    ``labels`` (B, S) run DeepSeek-V3's MTP block into aux.

    With ``taps=True`` it returns ``(primary, aux, taps)``: ``taps
    ["layer_out"]`` the (L, B, S, D) hidden states after each layer (patch
    positions included for vlm; outer super-blocks for hybrid; decoder
    layers for audio), and for moe ``taps["router_logits"]`` the (L, T, E)
    f32 router logits — the monitor's intercept hook.
    """
    with full_f32():
        if cfg.family == "audio":
            return _forward_encdec(params, cfg, batch,
                                   return_hidden=return_hidden, taps=taps)
        h = _prompt(params, cfg, batch)
        h = sharding.hint(h, "dp", "model" if cfg.seq_shard else None, None)
        cos, sin = _rope_tables(cfg, _positions(h, 0, h.shape[1]))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        outs, router = [], []
        layers, fam = params["layers"], cfg.family
        run = _remat(cfg)

        # each body gathers its layer's FSDP shards itself, so that under
        # remat the checkpoint keeps the shards, not the gathered weights,
        # and the backward gathers again (the reference scans the sharded
        # stack through its remat'd body)
        def dense(i, h):
            return _dense_block(_layer(layers, i), h, cfg, cos, sin)[0]

        def moe_layer(i, h):
            h, a, _, logits = _moe_block(_layer(layers, i), h, cfg, cos, sin,
                                         taps=taps)
            return h, a, logits

        def ssm(i, h):
            return rwkv_block(_layer(layers, i), h, cfg)[0]

        def super_block(i, h):
            for j in range(cfg.attn_every - 1):
                h, _ = _mamba_residual(_layer(layers, i, j), h, cfg)
            return _dense_block(_layer(params["shared_attn"]), h, cfg, cos,
                                sin)[0]

        if fam in ("dense", "vlm", "ssm", "moe"):
            for i in range(cfg.n_layers):
                if fam == "moe":
                    h, a, logits = run(moe_layer, i, h)
                    aux = aux + a
                    router.append(logits)
                else:
                    h = run(ssm if fam == "ssm" else dense, i, h)
                if taps:
                    outs.append(h)
        elif fam == "hybrid":
            for i in range(cfg.n_layers // cfg.attn_every):
                h = run(super_block, i, h)
                if taps:
                    outs.append(h)
        else:
            raise ValueError(fam)

        if fam == "moe" and cfg.mtp and "mtp_block" in params \
                and "labels" in batch:
            aux = aux + _mtp_loss(params, cfg, h, batch, cos, sin)
        if fam == "vlm":
            h = h[:, batch["patches"].shape[1]:, :]
        primary = h if return_hidden else _lm_head(params, cfg, h)
    if taps:
        tap_tree = {"layer_out": torch.stack(outs)}
        if fam == "moe":
            tap_tree["router_logits"] = torch.stack(router)
        return primary, aux, tap_tree
    return primary, aux


def _next(t):
    """``torch.roll(t, -1, dims=1)`` as a ``cat`` of two slices, which
    ``DTensor`` shards under every torch version (a roll it may not)."""
    return torch.cat([t[:, 1:], t[:, :1]], dim=1)


def _mtp_loss(params, cfg, h, batch, cos, sin):
    """DeepSeek-V3 multi-token prediction: one extra block predicts t+2."""
    p = _layer(params["mtp_block"])
    tokens = _tokens(params, batch["tokens"])
    e = _embed_tokens(params, cfg, _next(tokens))
    hin = seq_whole(torch.cat([rms_norm(h, p["mtp_norm"], cfg.norm_eps), e],
                              dim=-1)) @ p["mtp_proj"]
    hout, _ = _dense_block(p, hin, cfg, cos, sin)
    S = hout.shape[1]
    labels2 = _next(_tokens(params, batch["labels"]))
    tail = torch.arange(S, device=h.device)[None, :] >= S - 2
    labels2 = labels2.masked_fill(tail, -1)
    ce, _, cnt = ce_from_hidden(params, cfg, hout, labels2,
                                chunk=cfg.ce_chunk)
    return 0.3 * ce / torch.clamp_min(cnt, 1.0)


def _encode(params, cfg, frames):
    """Whisper's encoder over precomputed frame embeddings."""
    h = frames.to(device=params["embed"].device, dtype=params["embed"].dtype)
    cos, sin = _rope_tables(cfg, _positions(h, 0, h.shape[1]))
    enc, run = params["enc_layers"], _remat(cfg)

    def body(i, h):     # gathers inside the remat, as ``forward``'s bodies
        return _dense_block(_layer(enc, i), h, cfg, cos, sin,
                            causal=False)[0]

    for i in range(cfg.n_enc_layers):
        h = run(body, i, h)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _cross_kv(lp, enc_out, cfg):
    Hkv, hd = cfg.eff_kv_heads, cfg.head_dim
    Be, Se, _ = enc_out.shape
    k = (enc_out @ lp["x_wk"]).reshape(Be, Se, Hkv, hd)
    v = (enc_out @ lp["x_wv"]).reshape(Be, Se, Hkv, hd)
    return k, v


def _forward_encdec(params, cfg, batch, *, return_hidden=False, taps=False):
    """Whisper: encoder over precomputed frame embeddings + causal decoder."""
    enc_out = _encode(params, cfg, batch["enc_frames"])
    h = _embed_tokens(params, cfg, _tokens(params, batch["tokens"]))
    cos, sin = _rope_tables(cfg, _positions(h, 0, h.shape[1]))
    outs, run = [], _remat(cfg)

    def body(i, h):     # gathers inside the remat, as ``forward``'s bodies
        lp = _layer(params["layers"], i)
        return _dec_block(lp, h, cfg, cos, sin,
                          _cross_kv(lp, enc_out, cfg))[0]

    for i in range(cfg.n_layers):
        h = run(body, i, h)
        if taps:
            outs.append(h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    primary = h if return_hidden else _lm_head(params, cfg, h)
    if taps:
        return primary, aux, {"layer_out": torch.stack(outs)}
    return primary, aux


def _dec_block(lp, h, cfg, cos, sin, enc_kv, cache=None, pos=0):
    a, new_cache = gqa_block(lp, rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
                             cos, sin, causal=True, cache=cache, pos=pos)
    h = h + a
    xp = {k[2:]: v for k, v in lp.items() if k.startswith("x_")}
    hx = rms_norm(h, lp["ln_x_attn"], cfg.norm_eps)
    h = h + cross_block(xp, hx, enc_kv, cfg)
    h = h + dense_ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    return h, new_cache


# ------------------------------------------------------------- decode ----


def _kv_cache(lead, batch, seq, cfg, dtype, device) -> KVCache:
    shape = (*lead, batch, seq, cfg.eff_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero-filled decoding cache for ``batch`` streams of up to
    ``max_len`` positions on ``device``: ``{"kv": KVCache}`` (dense, vlm,
    GQA moe; audio adds ``"enc_kv"``, the cross-attention keys and
    values), ``{"mla": MLACache}`` (MLA moe), ``{"rwkv": RWKVState}``
    (ssm), or ``{"mamba": MambaState, "kv": KVCache}`` (hybrid), each
    leaf stacked over the layers.  Recurrent states are f32, the rest
    ``dtype``; ``device="meta"`` gives the shapes only."""
    fam, L = cfg.family, cfg.n_layers
    if fam in ("dense", "vlm", "audio") or (fam == "moe" and not cfg.use_mla):
        cache = {"kv": _kv_cache((L,), batch, max_len, cfg, dtype, device)}
        if fam == "audio":
            cache["enc_kv"] = tuple(_kv_cache((L,), batch, cfg.enc_seq, cfg,
                                              dtype, device))
        return cache
    if fam == "moe":  # MLA latent cache
        return {"mla": MLACache(
            c_kv=torch.zeros((L, batch, max_len, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            k_rope=torch.zeros((L, batch, max_len, cfg.qk_rope_dim),
                               dtype=dtype, device=device))}
    if fam == "ssm":
        return {"rwkv": init_rwkv_state(cfg, batch, dtype, device, (L,))}
    if fam == "hybrid":
        nsb = L // cfg.attn_every
        return {"mamba": init_mamba_state(cfg, batch, dtype, device,
                                          (nsb, cfg.attn_every - 1)),
                "kv": _kv_cache((nsb,), batch, max_len, cfg, dtype, device)}
    raise ValueError(fam)


def _layer_cache(cache, i):
    return type(cache)(*(t[i] for t in cache))


def _stacked(states, cls):
    """Per-layer states (a list, or a list of lists) -> one stacked."""
    if isinstance(states[0], list):
        states = [_stacked(s, cls) for s in states]
    return cls(*(torch.stack(f) for f in zip(*states)))


def _cast_like(state, like):
    return type(like)(*(n.to(c.dtype) for n, c in zip(state, like)))


def _stack_step(params, cfg, h, cos, sin, cache, pos, *, prefill):
    """The layer stack of ``decode_step`` (or of ``prefill`` from an empty
    cache at position 0) over h (B,S,D); returns (h, new cache)."""
    fam, layers = cfg.family, params["layers"]
    if fam in ("dense", "vlm", "moe"):
        key = "mla" if cfg.use_mla else "kv"
        for i in range(cfg.n_layers):
            lp, c = _layer(layers, i), _layer_cache(cache[key], i)
            if fam == "moe":
                h = _moe_block(lp, h, cfg, cos, sin, cache=c, pos=pos)[0]
            else:
                h = _dense_block(lp, h, cfg, cos, sin, cache=c, pos=pos)[0]
        return h, cache
    if fam == "ssm":
        states = []
        for i in range(cfg.n_layers):
            st = None if prefill else _layer_cache(cache["rwkv"], i)
            h, ns = rwkv_block(_layer(layers, i), h, cfg, state=st,
                               return_state=prefill)
            states.append(ns)
        new = _stacked(states, RWKVState)
        return h, {"rwkv": _cast_like(new, cache["rwkv"]) if prefill
                   else new}
    if fam == "hybrid":
        states = []
        for i in range(cfg.n_layers // cfg.attn_every):
            inner = []
            for j in range(cfg.attn_every - 1):
                st = None if prefill else MambaState(
                    *(t[i, j] for t in cache["mamba"]))
                h, ns = _mamba_residual(_layer(layers, i, j), h, cfg,
                                        state=st, return_state=prefill)
                inner.append(ns)
            states.append(inner)
            h, _ = _dense_block(_layer(params["shared_attn"]), h, cfg, cos,
                                sin, cache=_layer_cache(cache["kv"], i),
                                pos=pos)
        new = _stacked(states, MambaState)
        return h, {"mamba": _cast_like(new, cache["mamba"]) if prefill
                   else new, "kv": cache["kv"]}
    raise ValueError(fam)


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: dict,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One token step at host position ``pos``: tokens (B,1) -> (logits
    (B,1,V) f32, cache).  The KV / latent caches are written in place and
    returned; recurrent states come back as new tensors."""
    with full_f32():
        h = _embed_tokens(params, cfg, _tokens(params, tokens))
        cos, sin = _rope_tables(cfg, _positions(h, pos, 1))
        if cfg.family == "audio":
            kv, (ek, ev) = cache["kv"], cache["enc_kv"]
            for i in range(cfg.n_layers):
                h, _ = _dec_block(_layer(params["layers"], i), h, cfg, cos,
                                  sin, (ek[i], ev[i]),
                                  cache=_layer_cache(kv, i), pos=pos)
        else:
            h, cache = _stack_step(params, cfg, h, cos, sin, cache, pos,
                                   prefill=False)
        return _lm_head(params, cfg, h), cache


# ------------------------------------------------------- chunked loss ----


def _sharded_lse(logits):
    """logsumexp of vocab-sharded logits from ops that ``DTensor`` shards
    on every version (``torch.logsumexp`` gathers the whole vocabulary on
    some): a settled max, then a settled sum of exps."""
    m = sharding.settle(logits.amax(-1, keepdim=True)).detach()
    s = sharding.settle(torch.exp(logits - m).sum(-1, keepdim=True))
    return (m + torch.log(s))[..., 0]


def _label_logits(params, cfg, h, labels):
    """The labels' logits from final hidden states: the normed state
    against the label's row of the output table, a vocab-parallel lookup
    (under a mesh, in place of a gather from the vocab-sharded logits,
    whose backward scatters into a whole vocabulary on some versions).
    The same products, summed in f32 in another order."""
    table = (params["embed"] if cfg.tie_embeddings
             else params["lm_head"].T)
    rows = sharding.settle(F.embedding(labels.clamp_min(0).long(),
                                       sharding.gather_fsdp(table)))
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return (hn.float() * rows.float()).sum(-1)


def ce_sums(logits, labels, ll=None):
    """(sum CE, sum lse^2, token count) with labels<0 masked out; ``ll``
    the labels' logits when the caller has them (else gathered)."""
    mask = (labels >= 0).float()
    if sharding.dp_axes() is None:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        lse = _sharded_lse(logits)
    if ll is None:
        ll = torch.gather(logits, -1,
                          labels.clamp_min(0)[..., None].long())[..., 0]
    return (torch.sum((lse - ll) * mask), torch.sum(torch.square(lse) * mask),
            torch.sum(mask))


def ce_from_hidden(params, cfg: ModelConfig, h, labels, *, chunk: int = 0):
    """CE sums from final hidden states; chunk>0 walks sequence chunks so
    the (B, S, V) f32 logits never materialize at once (``train/steps.py::
    loss_fn`` differentiates through it).  Under a mesh the labels'
    logits come from ``_label_logits``."""
    def sums(hc, lc):
        ll = (None if sharding.dp_axes() is None
              else _label_logits(params, cfg, hc, lc))
        return ce_sums(_lm_head(params, cfg, hc), lc, ll)

    B, S, D = h.shape
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        return sums(h, labels)
    ce = z = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        c, zz, n = sums(h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        ce, z, cnt = ce + c, z + zz, cnt + n
    return ce, z, cnt


# ------------------------------------------------------ serving prefill ----


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int,
            cache_dtype=torch.bfloat16):
    """Full-sequence prefill that RETURNS the decode cache.

    The serving handoff: run the prompt once, keep per-layer KV/latent/
    state, then ``decode_step`` continues from the returned position.
    Attention blocks run in cache mode against a zero cache at position 0
    with the whole prompt as one step; the recurrent families run the
    full sequence and keep the final state; audio encodes once and keeps
    the cross-attention keys and values.

    Returns (logits (B,S,V) f32, cache, next position as a host int,
    patches included for vlm).
    """
    with full_f32():
        h = _prompt(params, cfg, batch)
        B, S = h.shape[:2]
        cache = init_cache(cfg, B, max_len, cache_dtype, h.device)
        cos, sin = _rope_tables(cfg, _positions(h, 0, S))
        if cfg.family == "audio":
            enc_out = _encode(params, cfg, batch["enc_frames"])
            eks, evs = cache["enc_kv"]
            for i in range(cfg.n_layers):
                lp = _layer(params["layers"], i)
                ek, ev = _cross_kv(lp, enc_out, cfg)
                h, _ = _dec_block(lp, h, cfg, cos, sin, (ek, ev),
                                  cache=_layer_cache(cache["kv"], i), pos=0)
                eks[i] = ek.to(cache_dtype)
                evs[i] = ev.to(cache_dtype)
        else:
            h, cache = _stack_step(params, cfg, h, cos, sin, cache, 0,
                                   prefill=True)
        if cfg.family == "vlm":
            h = h[:, cfg.n_patches:, :]
        return _lm_head(params, cfg, h), cache, S

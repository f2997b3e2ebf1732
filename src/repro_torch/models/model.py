"""Model zoo assembly: init and forward for the ``dense`` and ``vlm``
families.

One parameter dict + pure-function design, as ``repro/models/model.py``:

  init_params(cfg, generator, dtype, device)   -> params dict of tensors
  forward(params, cfg, batch)                  -> (logits, aux_loss)
  params_from_numpy(tree, device, dtype)       -> the reference's weights

Layers are *stacked* (a leading L axis on every leaf of
``params["layers"]``); the forward walks them in a Python loop where the
reference scans.  The tree, its leaf names and shapes are the reference's,
and ``init_params`` draws the leaves in the reference's order (embed,
lm_head unless tied, then the layer leaves by sorted name) from one
``torch.Generator``; JAX's draws cannot be reproduced in torch, so the
weights differ and ``params_from_numpy`` carries the reference's own
across.  The products run in full f32 (``kernels.ref.full_f32``): no
TF32, whatever the process set.

The other families (moe with MLA, ssm, hybrid, audio), the decode cache
and prefill are not ported yet (``ROADMAP.md`` queue 1): ``init_params``
and ``forward`` raise ``NotImplementedError`` for them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import full_f32
from repro_torch.models.attention import gqa_block
from repro_torch.models.common import dense_init, rms_norm, rope_freqs
from repro_torch.models.moe import dense_ffn

#: The families whose init and forward are ported.
PORTED_FAMILIES = ("dense", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP.md queue 1); ported families: "
            f"{PORTED_FAMILIES}")


# --------------------------------------------------------------- init ----


def _init_tree(generator: torch.Generator, spec: dict, dtype,
               device) -> dict:
    """spec: name -> (shape, scale|None|"zeros"|"ones"); leaves drawn in
    sorted name order."""
    out = {}
    for name, (shape, scale) in sorted(spec.items()):
        if scale == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif scale == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = dense_init(generator, shape, scale, dtype, device)
    return out


def _attn_spec(cfg: ModelConfig, L: tuple[int, ...]) -> dict:
    D = cfg.d_model
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


def _block_spec(cfg: ModelConfig, L: tuple[int, ...]) -> dict:
    spec = {"ln1": ((*L, cfg.d_model), "zeros"),
            "ln2": ((*L, cfg.d_model), "zeros")}
    spec.update(_attn_spec(cfg, L))
    spec.update(_ffn_spec(cfg, L, cfg.d_ff))
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                dtype=torch.float32, device="cuda") -> dict:
    """Random weights for ``cfg`` on ``device`` (``generator`` lives
    there): ``embed`` (padded_vocab, d_model) at scale 0.02,
    ``final_norm``, ``lm_head`` unless tied, and ``layers`` with stacked
    (n_layers, …) leaves."""
    _require_ported(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": dense_init(generator, (V, D), 0.02, dtype, device),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (D, V), None, dtype,
                                       device)
    params["layers"] = _init_tree(generator,
                                  _block_spec(cfg, (cfg.n_layers,)), dtype,
                                  device)
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


def _dense_block(p, h, cfg, cos, sin):
    h = h + gqa_block(p, rms_norm(h, p["ln1"], cfg.norm_eps), cfg, cos, sin)
    return h + dense_ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg)


def _embed_tokens(params, cfg, tokens):
    h = params["embed"][tokens]
    if cfg.tie_embeddings:  # gemma-style input scaling
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def _lm_head(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = (h @ params["embed"].T).float()
    else:
        logits = (h @ params["lm_head"]).float()
    if cfg.padded_vocab != cfg.vocab:   # mask padding rows out of softmax
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _rope_tables(cfg, positions):
    return rope_freqs(positions, cfg.head_dim, cfg.rope_theta)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            return_hidden: bool = False, taps: bool = False):
    """Full-sequence forward on the params' device.  Returns (logits
    (B,S,V) f32, aux_loss 0-d f32), or (final hidden states, aux) with
    ``return_hidden=True``.

    batch: ``tokens`` (B, S[-n_patches]) int (numpy or tensor); vlm adds
    ``patches`` (B, n_patches, D), prepended to the token embeddings and
    stripped after the stack.

    With ``taps=True`` it returns ``(primary, aux, {"layer_out": (L, B, S,
    D)})``: the hidden states after each layer (patch positions included
    for vlm), the monitor's intercept hook.

    ``cfg.remat`` has no meaning without autograd and is ignored until
    the training slice.
    """
    _require_ported(cfg)
    embed = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=embed.device).long()
    with full_f32():
        h = _embed_tokens(params, cfg, tokens)
        if cfg.family == "vlm":
            h = torch.cat([batch["patches"].to(device=h.device,
                                               dtype=h.dtype), h], dim=1)
        S = h.shape[1]
        cos, sin = _rope_tables(cfg, torch.arange(S, device=h.device))
        layers = params["layers"]
        outs = []
        for i in range(cfg.n_layers):
            h = _dense_block({k: v[i] for k, v in layers.items()}, h, cfg,
                             cos, sin)
            if taps:
                outs.append(h)
        if cfg.family == "vlm":
            h = h[:, batch["patches"].shape[1]:, :]
        primary = h if return_hidden else _lm_head(params, cfg, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if taps:
        return primary, aux, {"layer_out": torch.stack(outs)}
    return primary, aux

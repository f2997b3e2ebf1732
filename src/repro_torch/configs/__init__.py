"""Architecture registry: exact assigned configs + reduced smoke variants.

The reference's ``repro/configs``, value for value (the port keeps its own
copy).  ``models/model.py`` runs every family.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig, SHAPES

from repro_torch.configs.zamba2_2p7b import CONFIG as zamba2_2p7b
from repro_torch.configs.phi3_mini_3p8b import CONFIG as phi3_mini_3p8b
from repro_torch.configs.nemotron_4_15b import CONFIG as nemotron_4_15b
from repro_torch.configs.gemma_2b import CONFIG as gemma_2b
from repro_torch.configs.starcoder2_7b import CONFIG as starcoder2_7b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.rwkv6_3b import CONFIG as rwkv6_3b
from repro_torch.configs.phi35_moe_42b import CONFIG as phi35_moe_42b
from repro_torch.configs.deepseek_v3_671b import CONFIG as deepseek_v3_671b
from repro_torch.configs.internvl2_1b import CONFIG as internvl2_1b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    zamba2_2p7b, phi3_mini_3p8b, nemotron_4_15b, gemma_2b, starcoder2_7b,
    whisper_large_v3, rwkv6_3b, phi35_moe_42b, deepseek_v3_671b, internvl2_1b,
]}

# archs with sub-quadratic sequence mixing run the 500k-context cell
SUBQUADRATIC = {"zamba2-2.7b", "rwkv6-3b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(arch: str) -> list[str]:
    """Shape names this arch runs (long_500k only for sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        names.append("long_500k")
    return names


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, runs a CPU step in seconds."""
    cfg = get_config(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab=128,
        attn_chunk=8, ssm_chunk=8, remat="none",
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff_expert=64)
        if cfg.use_mla:
            kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, attn_every=2, ssm_state=16, ssm_head_dim=16)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16)
    if cfg.family == "audio":
        kw.update(n_enc_layers=2, enc_seq=16)
    if cfg.family == "vlm":
        kw.update(n_patches=4)
    return cfg.replace(**kw)


__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES", "ARCHS",
           "SUBQUADRATIC", "get_config", "cells", "smoke_config"]

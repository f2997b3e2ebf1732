"""Zamba2-2.7B — Mamba2 backbone + shared GQA attention block.

[arXiv:2411.15242; hf] 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  Hybrid layout: one *shared* attention+MLP
block (single weight set) applied every 6 layers between Mamba2 blocks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000, act="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
)

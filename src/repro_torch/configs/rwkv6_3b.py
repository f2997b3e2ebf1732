"""RWKV6-3B (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65536, act="relu2", rwkv_head_dim=64,
)

"""InternVL2-1B — InternViT frontend STUBBED (precomputed patch embeddings)
+ 0.5B-class LM backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655, act="swiglu",
    n_patches=256, tie_embeddings=True,
)

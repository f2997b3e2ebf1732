"""DeepSeek-V3-671B (37B active) — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]

Deviation noted in DESIGN.md: the paper's first 3 dense layers are modeled
as MoE layers too (uniform stack keeps the scan compact); expert width
2048, MLA dims q_lora=1536 kv_lora=512 nope=128 rope=64 v=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab=129280, act="swiglu",
    n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, mtp=True,
)

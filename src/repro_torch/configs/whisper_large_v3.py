"""Whisper-large-v3 backbone — enc-dec transformer; conv frontend STUBBED
(input_specs supplies precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, act="gelu",
    is_encdec=True, n_enc_layers=32, enc_seq=1500,
)

"""Model / run configuration dataclasses shared by the whole framework.

The reference's ``repro/configs/base.py``, field for field: the port keeps
its own copy and imports nothing of ``repro``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"         # swiglu | geglu | relu2 | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    route_groups: int = 0       # DeepSeek group-limited routing: experts
    route_top_groups: int = 0   # partitioned into groups, top-g selected
                                # per token before expert top-k (locality)
    # --- MLA (DeepSeek-V3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False           # multi-token-prediction auxiliary head
    # --- SSM / hybrid ---
    ssm_state: int = 0          # Mamba2 d_state / RWKV6 head size
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0         # zamba2: one shared attn block every k layers
    rwkv_head_dim: int = 64
    # --- encoder/decoder (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500         # precomputed audio frame embeddings (stub)
    # --- VLM ---
    n_patches: int = 0          # precomputed ViT patch embeddings (stub)
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"         # none | full | dots
    attn_chunk: int = 512       # q-chunk for blocked causal attention
    seq_shard: bool = False     # sequence-parallel activation sharding
    vocab_pad: int = 0          # pad embed rows to a multiple (0 = exact);
                                # lets odd vocabs (51866, 151655) TP-shard
    ce_chunk: int = 0           # seq-chunked CE loss (0 = full logits)
    head_pad: int = 0           # pad head counts to a multiple (0 = exact);
                                # extra heads' output rows init to zero —
                                # lets odd head counts (20, 36, 14) TP-shard

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad <= 0:
            return self.vocab
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    @property
    def eff_heads(self) -> int:
        # padding is only group-mapping-safe for MHA (q == kv head count);
        # GQA padding would re-pair query groups with the wrong KV heads
        if self.head_pad <= 0 or self.n_heads != self.n_kv_heads:
            return self.n_heads
        return -(-self.n_heads // self.head_pad) * self.head_pad

    @property
    def eff_kv_heads(self) -> int:
        if self.head_pad <= 0 or self.n_heads != self.n_kv_heads:
            return self.n_kv_heads
        return -(-self.n_kv_heads // self.head_pad) * self.head_pad

    @property
    def q_dim(self) -> int:
        return self.eff_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.eff_kv_heads * self.head_dim

    @property
    def gated(self) -> bool:
        return self.act in ("swiglu", "geglu")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    optimizer: str = "adamw"    # adamw | adafactor
    seed: int = 0
    # fault tolerance / scale knobs
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    diag_every: int = 25        # VAT diagnostics cadence
    compress_grads: bool = False
    topk_frac: float = 0.05     # gradient-compression keep fraction

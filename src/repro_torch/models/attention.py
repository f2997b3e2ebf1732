"""Attention: GQA/MQA with q-chunked causal attention.

As ``repro/models/attention.py``'s training/prefill path, on tensors, in
the reference's arithmetic order: query heads grouped (B, S, Hkv, rep,
hd), so query head g·rep + r reads KV head g; scores in f32 scaled by
hd^-0.5 after the product; the causal mask writes -1e30; the
softmax in f32, cast to v's dtype before the value product.  With
``chunk`` the (S x S) score matrix never materializes: each q-chunk
computes a (chunk x S) row block, masks, softmaxes and contracts at once.
The products are plain torch (``torch.einsum``), as the reference computes
them outside any Pallas kernel; ``scaled_dot_product_attention`` is not
used, since its masking and order are not the reference's.

The reference's decode cache (``KVCache``), ``cross_block`` and MLA come
with the families that need them (``ROADMAP.md`` queue 1).  Its sharding
hints are the identity without a mesh, so the port has none.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_rope

_NEG = -1e30


def _block_attn(qg, k, v, qpos, kv_idx, causal):
    """qg (B,L,G,R,hd) vs k/v (B,K,G,hd) -> (B,L,G,R,hd)."""
    scale = qg.shape[-1] ** -0.5
    s = torch.einsum("blgrh,bkgh->bgrlk", qg.float(), k.float()) * scale
    if causal:
        mask = kv_idx[None, :] <= qpos[:, None]          # (L, K)
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bgrlk,bkgh->blgrh", p, v)


def attention(q, k, v, *, causal: bool = True, chunk: int = 0):
    """q (B,S,H,hd), k/v (B,K,Hkv,hd) -> (B,S,H,hd); GQA via head groups."""
    B, S, H, hd = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd)
    kv_idx = torch.arange(K, device=q.device)
    qpos_all = torch.arange(S, device=q.device)

    if chunk and S > chunk and S % chunk == 0:
        outs = [_block_attn(qg[:, i:i + chunk], k, v, qpos_all[i:i + chunk],
                            kv_idx, causal)
                for i in range(0, S, chunk)]
        return torch.cat(outs, dim=1).reshape(B, S, H, vd)
    return _block_attn(qg, k, v, qpos_all, kv_idx, causal).reshape(B, S, H, vd)


def gqa_block(p, h, cfg, cos, sin):
    """Causal self-attention sublayer (projections + rope + attn + out
    proj) over a full sequence h (B,S,D)."""
    B, S, D = h.shape
    H, Hkv, hd = cfg.eff_heads, cfg.eff_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, S, Hkv, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    if H != cfg.n_heads:
        # padded heads (TP-divisibility) are masked out: function-
        # equivalent to the unpadded architecture
        keep = torch.arange(H, device=out.device) < cfg.n_heads
        out = out * keep[None, None, :, None]
    out = out.reshape(B, S, H * hd)
    return out @ p["wo"]

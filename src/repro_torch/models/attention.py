"""Attention: GQA/MQA (q-chunked causal), MLA (DeepSeek), cross-attention,
and their decode caches.

As ``repro/models/attention.py``, on tensors, in the reference's
arithmetic order: query heads grouped (B, S, Hkv, rep, hd), so query head
g·rep + r reads KV head g; scores in f32 scaled by hd^-0.5 after the
product; the causal mask (key position <= the query's absolute position,
``q_offset`` + its index) writes -1e30; the softmax in f32, cast to v's
dtype before the value product.  With ``chunk`` the (S x S) score matrix
never materializes: each q-chunk computes a (chunk x S) row block, masks,
softmaxes and contracts at once.  The products are plain torch
(``torch.einsum``), as the reference computes them outside any Pallas
kernel; ``scaled_dot_product_attention`` is not used, since its masking
and order are not the reference's.

The decode caches are ``NamedTuple``s of tensors.  A block given a cache
writes the step's keys and values into it at ``pos`` **in place** (the
reference's ``dynamic_update_slice``) and returns it.  Where the
reference's dtype promotion meets a product of mixed dtypes (an f32 query
against a bfloat16 cache), the port casts to the promoted dtype first,
since torch's products do not promote.  The q, k and v projections carry
the reference's sharding hints (``models/sharding.py::hint``: heads over
``model``, batch over the DP axes), the identity without a mesh; placed
alike, attention runs on each rank's shards (``sharding.on_shards``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import sharding
from repro_torch.models.common import (apply_rope, rms_norm, seq_whole,
                                       seq_whole_grad)

_NEG = -1e30


def _promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` in the dtype JAX would promote ``a`` and ``b`` to."""
    return a.to(torch.promote_types(a.dtype, b.dtype))


def _block_attn(qg, k, v, qpos, kv_idx, causal):
    """qg (B,L,G,R,hd) vs k/v (B,K,G,hd) -> (B,L,G,R,hd)."""
    scale = qg.shape[-1] ** -0.5
    s = torch.einsum("blgrh,bkgh->bgrlk", qg.float(), k.float()) * scale
    if causal:
        mask = kv_idx[None, :] <= qpos[:, None]          # (L, K)
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        # p's (r, l) rows, permuted after: split query heads (r) cannot be
        # flattened into "blgrh"'s (l, r) rows under every torch version.
        # v's gradient sums in another order, so plain tensors (each
        # rank's shards too) keep the reference's form
        return torch.einsum("bgrlk,bkgh->bgrlh", p, v).permute(0, 3, 1, 2,
                                                                4)
    return torch.einsum("bgrlk,bkgh->blgrh", p, v)


def attention(q, k, v, *, causal: bool = True, chunk: int = 0,
              q_offset: int = 0):
    """q (B,S,H,hd), k/v (B,K,Hkv,hd) -> (B,S,H,vd); GQA via head groups.

    Query i sits at absolute position ``q_offset + i`` (a decode step's
    or a prefill's place in the cache)."""
    S = q.shape[1]
    if not (chunk and S > chunk and S % chunk == 0):
        chunk = 0

    def run(q, k, v):
        return (_attention(q, k, v, causal, chunk, q_offset),)
    # under a mesh, attention runs on each rank's batch rows and heads when
    # q, k and v split them alike (so GQA's groups stay whole on a rank):
    # no q-chunk reshards, and no product flattens a split dim
    if sharding.placed_alike((q, k, v), dims=(0, 2)):
        return sharding.on_shards(run, (q, k, v), like=(q,))[0]
    return run(q, k, v)[0]


def _attention(q, k, v, causal, chunk, q_offset):
    B, S, H, hd = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]  # may differ from hd (MLA: qk dim != v dim)
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd)
    kv_idx = torch.arange(K, device=q.device)
    qpos_all = q_offset + torch.arange(S, device=q.device)

    if chunk:
        outs = [_block_attn(qg[:, i:i + chunk], k, v, qpos_all[i:i + chunk],
                            kv_idx, causal)
                for i in range(0, S, chunk)]
        return torch.cat(outs, dim=1).reshape(B, S, H, vd)
    return _block_attn(qg, k, v, qpos_all, kv_idx, causal).reshape(B, S, H, vd)


class KVCache(NamedTuple):
    k: torch.Tensor  # ([L,] B, Smax, Hkv, hd)
    v: torch.Tensor


def _mask_padded_heads(out, cfg):
    H = out.shape[2]
    if H != cfg.n_heads:
        # padded heads (TP-divisibility) are masked out: function-
        # equivalent to the unpadded architecture
        keep = torch.arange(H, device=out.device) < cfg.n_heads
        out = out * keep[None, None, :, None]
    return out


def gqa_block(p, h, cfg, cos, sin, *, causal=True,
              cache: KVCache | None = None, pos: int = 0):
    """Self-attention sublayer (projections + rope + attn + out proj).

    Train/prefill without a cache: h is (B,S,D), attention q-chunked.
    With a cache (Smax entries): the step's k and v are written into it
    at ``pos`` in place, and the S queries at positions pos.. attend
    over the whole cache, unchunked and causal.  Returns (out, cache or
    None)."""
    B, S, D = h.shape
    H, Hkv, hd = cfg.eff_heads, cfg.eff_kv_heads, cfg.head_dim
    h = seq_whole(h)
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, S, Hkv, hd)
    q = sharding.hint(q, "dp", None, "model", None)
    k = sharding.hint(k, "dp", None, "model", None)
    v = sharding.hint(v, "dp", None, "model", None)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is None:
        out = attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        cache.k[:, pos:pos + S] = k.to(cache.k.dtype)
        cache.v[:, pos:pos + S] = v.to(cache.v.dtype)
        out = attention(q, cache.k, cache.v, causal=True, q_offset=pos)
    out = _mask_padded_heads(out, cfg).reshape(B, S, H * hd)
    return seq_whole_grad(_promoted(out, p["wo"]) @ p["wo"]), cache


def cross_block(p, h, enc_kv, cfg):
    """Cross-attention sublayer (whisper decoder).  enc_kv = (k, v), each
    (B, enc_seq, Hkv, hd), any float dtype."""
    B, S, D = h.shape
    H, hd = cfg.eff_heads, cfg.head_dim
    q = (seq_whole(h) @ p["wq"]).reshape(B, S, H, hd)
    # the self-attention's placements (heads over "model"), so the three
    # are placed alike and attention runs on each rank's shards
    q, k, v = (sharding.hint(t, "dp", None, "model", None)
               for t in (q, *enc_kv))
    out = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    out = _mask_padded_heads(out, cfg).reshape(B, S, H * hd)
    return _promoted(out, p["wo"]) @ p["wo"]


# ---------------------------------------------------------------- MLA ----

class MLACache(NamedTuple):
    c_kv: torch.Tensor    # ([L,] B, Smax, kv_lora)  compressed latent
    k_rope: torch.Tensor  # ([L,] B, Smax, rope_dim) shared positional key


def _mla_qkv(p, h, cfg, cos, sin):
    """Expanded-form MLA projections (train / prefill)."""
    B, S, _ = h.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = rms_norm(h @ p["wq_a"], p["q_norm"], cfg.norm_eps)  # (B,S,q_lora)
    q = (cq @ p["wq_b"]).reshape(B, S, H, dn + dr)
    ckv_full = h @ p["wkv_a"]                           # (B,S,kv_lora+dr)
    c_kv = ckv_full[..., :cfg.kv_lora_rank]
    k_rope = ckv_full[..., cfg.kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # 1 shared head
    k_rope_b = k_rope.expand(B, S, H, dr)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    return q_full, k_full, v, c_kv, k_rope[:, :, 0, :]


def mla_block(p, h, cfg, cos, sin, *, cache: MLACache | None = None,
              pos: int = 0):
    """DeepSeek-V3 Multi-head Latent Attention sublayer.

    Without a cache, the expanded form (train / prefill's forward).  With
    one, the *absorbed* form: the step's latent and rope key are written
    into the cache at ``pos`` in place, and scores and context are
    computed in the compressed kv_lora space directly against the latent
    cache, so the per-token cache cost is kv_lora + rope_dim (576 for
    DSv3), not 2 * H * hd.  Returns (out, cache or None)."""
    B, S, D = h.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    h = seq_whole(h)
    if cache is None:
        q, k, v, _, _ = _mla_qkv(p, h, cfg, cos, sin)
        q = sharding.hint(q, "dp", None, "model", None)
        k = sharding.hint(k, "dp", None, "model", None)
        out = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
        return seq_whole_grad(out.reshape(B, S, H * dv) @ p["wo"]), None

    # ---- absorbed decode path ----
    cq = rms_norm(h @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, cos, sin)
    ckv_full = h @ p["wkv_a"]
    c_new = rms_norm(ckv_full[..., :cfg.kv_lora_rank], p["kv_norm"],
                     cfg.norm_eps)
    kr_new = apply_rope(ckv_full[..., None, cfg.kv_lora_rank:], cos,
                        sin)[:, :, 0, :]
    cache.c_kv[:, pos:pos + S] = c_new.to(cache.c_kv.dtype)
    cache.k_rope[:, pos:pos + S] = kr_new.to(cache.k_rope.dtype)
    c_kv, k_rope = cache

    wkv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    # absorb W_uk into q: (B,S,H,dn) x (l,H,dn) -> (B,S,H,l)
    q_c = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)
    scale = (dn + dr) ** -0.5
    s = (torch.einsum("bshl,bkl->bhsk", q_c.float(), c_kv.float())
         + torch.einsum("bshr,bkr->bhsk", q_rope.float(), k_rope.float())
         ) * scale
    kv_idx = torch.arange(c_kv.shape[1], device=h.device)
    qpos = pos + torch.arange(S, device=h.device)  # absolute positions
    s = s.masked_fill(~(kv_idx[None, :] <= qpos[:, None]), _NEG)
    pr = torch.softmax(s, dim=-1).to(c_kv.dtype)
    ctx_c = torch.einsum("bhsk,bkl->bshl", pr, c_kv)   # context in latent space
    out = torch.einsum("bshl,lhv->bshv", _promoted(ctx_c, w_uv),
                       _promoted(w_uv, ctx_c))         # absorb W_uv
    return out.reshape(B, S, H * dv) @ p["wo"], cache

"""RWKV-6 (Finch) block: data-dependent-decay linear attention, no KV cache.

As ``repro/models/rwkv6.py``.  Time-mix keeps a per-head (N x N) matrix
state updated once per token, so decode is O(1) in sequence length.  The
full sequence materializes r/k/v/w with products, then runs the
recurrence as a Python loop over the S positions where the reference
scans: plain torch, as the reference keeps it outside any Pallas kernel
(under a mesh, on each rank's shards: ``sharding.on_shards``).

The decay is the Finch LoRA form: w = exp(-exp(w0 + tanh(x W1) W2)),
data-dependent per channel per token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.common import (pad_front, rms_norm, seq_whole,
                                       seq_whole_grad)


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # ([L,] B, H, N, N) f32 linear-attention state
    tm_last: torch.Tensor  # ([L,] B, D) previous token (time-mix shift)
    cm_last: torch.Tensor  # ([L,] B, D) previous token (channel-mix shift)


def _heads(t, H, N):
    return t.reshape(*t.shape[:-1], H, N)


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu


def _shift(x):
    """x (B,S,D) moved one position later, zeros first."""
    return pad_front(x, 1)[:, :-1]


def _decay(xw, p):
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(p["w0"].float() + lora.float()))


def _wkv_scan(r, k, v, w, u, wkv):
    """The WKV recurrence over sequence-first r/k/v/w (S,B,H,N) from state
    ``wkv`` (B,H,N,N): the outputs (S,B,H,N) and the last state."""
    ys = []
    for t in range(r.shape[0]):
        kv = k[t, :, :, :, None] * v[t, :, :, None, :]  # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[t], wkv + u * kv))
        wkv = w[t, :, :, :, None] * wkv + kv
    return torch.stack(ys), wkv


def rwkv_block(p, hin, cfg, *, state: RWKVState | None = None,
               return_state: bool = False):
    """hin (B,S,D) residual stream -> (B,S,D), new state or None.

    state=None: full sequence (optionally return the final state for the
    serving prefill handoff).  state!=None with S==1: decode.
    """
    B, S, D = hin.shape
    N = cfg.rwkv_head_dim
    H = D // N

    # ---- time mix ----
    x = seq_whole(rms_norm(hin, p["ln1"], cfg.norm_eps))
    if state is None:
        xprev = _shift(x)
        wkv = torch.zeros((B, H, N, N), dtype=torch.float32,
                          device=hin.device)
    else:
        xprev = state.tm_last[:, None, :]
        wkv = state.wkv
    xr = _mix(x, xprev, p["mu_r"])
    xk = _mix(x, xprev, p["mu_k"])
    xv = _mix(x, xprev, p["mu_v"])
    xw = _mix(x, xprev, p["mu_w"])
    xg = _mix(x, xprev, p["mu_g"])
    r = _heads(xr @ p["w_recv"], H, N).float()
    k = _heads(xk @ p["w_key"], H, N).float()
    v = _heads(xv @ p["w_val"], H, N).float()
    g = F.silu(xg @ p["w_gateproj"])
    w = _heads(_decay(xw, p), H, N)                     # (B,S,H,N) in (0,1)
    u = p["u"].float()[None, :, :, None]                # (1,H,N,1)

    # sequence-first and contiguous, as the reference's scan reads them;
    # under a mesh the loop runs on each rank's heads (batch over the DP
    # axes, heads over "model" where they divide it), so no step reshards
    r, k, v, w = (sharding.hint(a.transpose(0, 1).contiguous(), None,
                                "dp", "model", None) for a in (r, k, v, w))
    u = sharding.hint(u, None, "model", None, None)
    wkv = sharding.hint(wkv, "dp", "model", None, None)
    ys, wkv = sharding.on_shards(_wkv_scan, (r, k, v, w, u, wkv),
                                 like=(r, wkv))
    # batch-first and contiguous: on the card the output product picks its
    # kernel by its operand's layout, and this layout keeps the bits
    y = ys.transpose(0, 1).contiguous().reshape(B, S, D).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    h = hin + seq_whole_grad(y @ p["w_out"])

    # ---- channel mix ----
    x2 = seq_whole(rms_norm(h, p["ln2"], cfg.norm_eps))
    x2prev = _shift(x2) if state is None else state.cm_last[:, None, :]
    hk = _mix(x2, x2prev, p["cm_mu_k"])
    hr = _mix(x2, x2prev, p["cm_mu_r"])
    kcm = sharding.hint(torch.square(F.relu(hk @ p["w_up"])), "dp", None,
                        "model")
    vcm = kcm @ p["w_down"]
    rcm = torch.sigmoid(hr @ p["w_recv_cm"])
    h = h + seq_whole_grad(rcm * vcm)

    new_state = None
    if state is not None or return_state:
        new_state = RWKVState(wkv=wkv, tm_last=x[:, -1, :],
                              cm_last=x2[:, -1, :])
    return h, new_state


def init_rwkv_state(cfg, batch: int, dtype, device="cuda",
                    lead: tuple[int, ...] = ()) -> RWKVState:
    """Zero state for ``batch`` streams (``lead``: stacked leading dims,
    e.g. (n_layers,)); wkv in f32, the shifts in ``dtype``."""
    D = cfg.d_model
    N = cfg.rwkv_head_dim
    H = D // N
    return RWKVState(
        wkv=torch.zeros((*lead, batch, H, N, N), dtype=torch.float32,
                        device=device),
        tm_last=torch.zeros((*lead, batch, D), dtype=dtype, device=device),
        cm_last=torch.zeros((*lead, batch, D), dtype=dtype, device=device))

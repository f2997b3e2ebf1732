"""Mamba2 (SSD — state-space duality) block, chunked matmul formulation.

As ``repro/models/mamba2.py``.  The full sequence runs the chunkwise
algorithm: within a chunk of length L the output is a masked (L x L)
product, between chunks a single (B,H,N,P) state carries through a Python
loop over the chunks where the reference scans — O(S) time, O(B H N P)
state.  Decode is the pure recurrence: h' = exp(dA) h + B (dt x);
y = C h + D x.  Plain torch, as the reference keeps it outside any Pallas
kernel; torch contracts the three-operand products in its own order, so
the results differ from XLA's by ulps.

The short causal conv over (x, B, C) keeps a (window-1)-deep conv state
for decode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.common import (pad_front, rms_norm, seq_whole,
                                       seq_whole_grad)

_CONV_W = 4  # short conv window


class MambaState(NamedTuple):
    ssm: torch.Tensor    # ([..,] B, H, N, P) f32
    conv: torch.Tensor   # ([..,] B, CONV_W-1, inner + 2N)


def _dims(cfg):
    inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = inner // P
    N = cfg.ssm_state
    return inner, H, P, N


def _split_proj(zxbcdt, cfg):
    inner, H, P, N = _dims(cfg)
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner:2 * inner + 2 * N]
    dt = zxbcdt[..., 2 * inner + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, conv_k):
    """Depthwise causal conv, window 4: xBC (B,S,C), conv_k (W,C)."""
    pad = pad_front(xBC, _CONV_W - 1)
    S = xBC.shape[1]
    out = 0
    for i in range(_CONV_W):       # the reference's sum(), from int 0
        out = out + pad[:, i:i + S, :] * conv_k[i]
    return F.silu(out)


def mamba_block(p, u, cfg, *, state: MambaState | None = None,
                return_state: bool = False):
    """u (B,S,D) -> (B,S,D), new state or None.

    state=None: full sequence (train / prefill); ``return_state=True``
    also returns the final recurrent state (serving prefill handoff).
    state!=None with S==1: single-token decode.
    """
    B, S, D = u.shape
    inner, H, P, N = _dims(cfg)
    u = seq_whole(u)
    zxbcdt = sharding.hint(u @ p["in_proj"], "dp", None, "model")
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    A = -torch.exp(p["a_log"].float())                        # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())        # (B,S,H)

    if state is None:
        xBC_raw = xBC
        xBC = _causal_conv(xBC, p["conv"])
        new_state = None
        x, Bm, Cm = (xBC[..., :inner], xBC[..., inner:inner + N],
                     xBC[..., inner + N:])
        xh = x.reshape(B, S, H, P)
        y, final_ssm = _ssd_chunked(xh, Bm, Cm, dt, A, cfg)    # f32
        y = y + p["skip_d"].float()[None, None, :, None] * xh.float()
        y = y.reshape(B, S, inner).to(u.dtype)
        if return_state:
            # conv state = last (window-1) *pre-conv* inputs
            pad = pad_front(xBC_raw, _CONV_W - 1)
            new_state = MambaState(ssm=final_ssm,
                                   conv=pad[:, S:S + _CONV_W - 1, :])
    else:
        # ---- decode: conv state + recurrence ----
        win = torch.cat([state.conv, xBC], dim=1)              # (B, W, C)
        win = win.to(torch.promote_types(win.dtype, p["conv"].dtype))
        conv_out = F.silu(torch.einsum("bwc,wc->bc", win, p["conv"]))
        new_conv = win[:, 1:, :]
        x = conv_out[:, :inner].reshape(B, H, P)
        Bm = conv_out[:, inner:inner + N]
        Cm = conv_out[:, inner + N:]
        dt1 = dt[:, 0]                                         # (B,H)
        dA = torch.exp(dt1 * A[None, :])                       # (B,H)
        xbar = x.float() * dt1[..., None]                      # (B,H,P)
        ssm = (state.ssm * dA[:, :, None, None]
               + torch.einsum("bn,bhp->bhnp", Bm.float(), xbar))
        y = torch.einsum("bn,bhnp->bhp", Cm.float(), ssm)
        y = y + p["skip_d"].float()[None, :, None] * x
        y = y.reshape(B, 1, inner).to(u.dtype)
        new_state = MambaState(ssm=ssm, conv=new_conv)

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return seq_whole_grad(y @ p["out_proj"]), new_state


def _ssd_chunked(x, Bm, Cm, dt, A, cfg):
    """Chunkwise SSD scan.

    x (B,S,H,P); Bm/Cm (B,S,N); dt (B,S,H); A (H,) -> y (B,S,H,P) f32 and
    the final state (B,H,N,P).  S must be a multiple of
    ``min(cfg.ssm_chunk, S)``, as the reference asserts.  Under a mesh the
    loop runs on each rank's heads (batch over the DP axes, heads over
    "model" where they divide it; Bm and Cm, shared by the heads, whole),
    so no chunk reshards.
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by ssm chunk {L}")
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    x = sharding.hint(x, "dp", None, "model", None)
    Bm, Cm = (sharding.hint(t, "dp", None, None) for t in (Bm, Cm))
    dt = sharding.hint(dt, "dp", None, "model")
    A = sharding.hint(A, "model")
    state = sharding.hint(state, "dp", "model", None, None)
    return sharding.on_shards(lambda *a: _ssd_scan(*a, L),
                              (x, Bm, Cm, dt, A, state), like=(x, state))


def _ssd_scan(x, Bm, Cm, dt, A, state, L):
    """``_ssd_chunked``'s loop over chunks of ``L`` from ``state``."""
    S = x.shape[1]
    xf = x.float() * dt[..., None]                              # xbar
    dA = dt * A[None, None, :]                                  # (B,S,H) <=0
    Bf, Cf = Bm.float(), Cm.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    ys = []
    for c0 in range(0, S, L):
        xc, bc, cc = xf[:, c0:c0 + L], Bf[:, c0:c0 + L], Cf[:, c0:c0 + L]
        seg = torch.cumsum(dA[:, c0:c0 + L], dim=1)             # (B,L,H)
        # inter-chunk: contribution of the carried state
        y_prev = torch.einsum("bln,bhnp->blhp", cc, state) \
            * torch.exp(seg)[..., None]
        # intra-chunk: masked decay matmul
        diff = seg[:, :, None, :] - seg[:, None, :, :]          # (B,L,L,H) t,s
        decay = torch.exp(diff.masked_fill(~tri[None, :, :, None],
                                           -torch.inf))
        cb = torch.einsum("bln,bsn->bls", cc, bc)
        y_intra = torch.einsum("bls,blsh,bshp->blhp", cb, decay, xc)
        # state update
        total = seg[:, -1]                                      # (B,H)
        edge = torch.exp(total[:, None, :] - seg)               # (B,L,H)
        state = (state * torch.exp(total)[:, :, None, None]
                 + torch.einsum("bsn,bsh,bshp->bhnp", bc, edge, xc))
        ys.append(y_prev + y_intra)
    return torch.cat(ys, dim=1), state


def init_mamba_state(cfg, batch: int, dtype, device="cuda",
                     lead: tuple[int, ...] = ()) -> MambaState:
    """Zero state for ``batch`` streams (``lead``: stacked leading dims);
    the SSM state in f32, the conv window in ``dtype``."""
    inner, H, P, N = _dims(cfg)
    return MambaState(
        ssm=torch.zeros((*lead, batch, H, N, P), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((*lead, batch, _CONV_W - 1, inner + 2 * N),
                         dtype=dtype, device=device))

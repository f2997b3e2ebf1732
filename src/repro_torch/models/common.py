"""Shared building blocks: norms, RoPE, activations, initializers.

As ``repro/models/common.py``, on tensors.  ``dense_init`` draws from an
explicit ``torch.Generator``: the reference's ``keygen`` key splitter has
no counterpart, since one generator is passed through and drawn from in
order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale``, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B,S,...) with ``n`` zero rows before its first, the values of
    ``F.pad(x, (0, 0, n, 0))``, by a ``cat``, which ``DTensor`` shards as
    ``x`` lies under every torch version (a pad it may not)."""
    zeros = torch.zeros_like(x[:, :1]).expand(x.shape[0], n, *x.shape[2:])
    return torch.cat([zeros, x], dim=1)


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """A sublayer's (B,S,D) input with its sequence whole on each rank
    (batch over the DP axes): under ``seq_shard`` the residual stream's
    sequence is split over "model", and a product's (B*S, D) view, a shift
    or a pad cannot carry that split, so the sublayer gathers it once
    here.  ``x`` itself without a mesh."""
    return sharding.hint(x, "dp", None, None)


def seq_whole_grad(x: torch.Tensor) -> torch.Tensor:
    """A sublayer's (B,S,D) output, whose gradient comes back with its
    sequence whole on each rank: under ``seq_shard`` the residual stream
    it joins splits the sequence over "model", and the product behind it
    cannot take that split in its backward.  The forward is ``x`` as it
    is; ``x`` itself without a mesh."""
    return sharding.grad_hint(x, "dp", None, None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _relu2(x: torch.Tensor) -> torch.Tensor:  # nemotron squared ReLU
    return torch.square(F.relu(x))


def activation(name: str):
    if name in ("swiglu",):
        return F.silu
    if name in ("geglu", "gelu"):
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(f"unknown activation {name}")


def rope_freqs(positions: torch.Tensor, dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for `positions` (any shape) over `dim` rope dims.

    The frequencies theta^(-i/half) are computed in f64 and rounded to f32
    (correctly rounded, as XLA's f32 power gives them; torch's f32 power
    may be an ulp off, which at positions in the thousands moves an angle
    by 1e-4)."""
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(theta, exps.double()).float()
    ang = positions.float()[..., None] * freq  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) with cos/sin (..., S, hd/2) — rotate-half
    convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over the head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def sinusoidal_pos(seq: int, dim: int, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """Classic transformer sinusoidal position table (whisper encoder)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10_000.0)
                    * torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device) / dim)
    tab = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab.to(dtype)


#: erf(∓2/√2): the uniform range whose inverse-erf image is N(0, 1)
#: truncated to [-2, 2], as ``jax.random.truncated_normal(key, -2, 2)``
#: draws it.
_ERF_LO, _ERF_HI = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))


def dense_init(generator: torch.Generator, shape: tuple[int, ...],
               scale: float | None = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init (0.02-style for embeds, 1/sqrt(fan_in)
    else): a standard normal truncated at ±2, drawn in f32 by the inverse
    error function (the reference's method; the draws differ), times
    ``scale``, cast to ``dtype``.  ``generator`` lives on ``device``; on
    "meta" nothing is drawn (a shape stand-in)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(_ERF_LO, _ERF_HI, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale)
    return t.to(dtype)

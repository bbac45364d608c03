"""Shared model layers: norms, RoPE, MLPs, the causal convolution, init
helpers.

The port of the JAX package's ``models/layers.py``. Everything computes
in float32 as the reference does; RoPE's frequencies and angles are f32
(not float64), so positions rotate by the reference's own rounding.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init: ``scale`` (default fan_in^-1/2) times
    a standard normal cut at ±3, drawn on the generator's device."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (scale * t).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             fused: bool = False) -> torch.Tensor:
    if fused:
        # the reduction in f32, no f32 copy of x kept (the reference's
        # bf16 training branch; in f32 it is the same arithmetic order)
        ss = torch.einsum("...d,...d->...", x.float(), x.float()) \
            / x.shape[-1]
        inv = torch.rsqrt(ss + eps)[..., None].to(x.dtype)
        return x * inv * weight
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE.

    x: (..., S, H, head_dim); positions: broadcastable to (..., S), int.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype),
        "w_up": dense_init(generator, (d_model, d_ff), dtype),
        "w_down": dense_init(generator, (d_ff, d_model), dtype),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution over the sequence axis.

    x: (B, S, C); w: (K, C); state: the K-1 inputs before ``x`` (B, K-1,
    C), zeros when None. Returns (y, new_state): y sums the K taps in tap
    order, as the reference does, and new_state is the last K-1 inputs,
    for single-step decode chaining (with K = 1, ``state`` unchanged).
    """
    K = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[:-2] + (K - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=-2)                  # (B, S+K-1, C)
    S = x.shape[-2]
    y = xp[..., 0:S, :] * w[0]
    for i in range(1, K):
        y = y + xp[..., i:i + S, :] * w[i]
    new_state = xp[..., S:, :] if K > 1 else state
    return y, new_state

"""Attention: grouped-query attention (GQA) with a ring-buffer KV cache.

The port of the GQA part of the JAX package's ``models/attention.py``.
The prefill path (:func:`gqa_forward`) runs its causal attention through
the flash-attention kernel (``kernels/flash_attention``); single-token
decode (:func:`cache_attention`) is plain tensor code, as in the
reference. Layouts are the reference's: (B, S, H, hd) for attention and
(B, W, Hkv, hd) for a layer's ring cache. Multi-head latent attention
(MLA) waits for a later slice (ROADMAP Queue 1).

Unlike the reference, :func:`gqa_decode` writes the new token's K and V
into the cache it is given, in place, and returns that cache: the port
keeps one copy of the ring instead of a new one per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_gqa(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(generator, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=dev)
    return p


def _grouped_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,hd); k,v: (B,Sk,Hkv,hd); mask broadcastable to
    (B,Hkv,G,Sq,Sk), bool."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, q_pos: torch.Tensor,
                    slot_pos: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Single-step decode attention over a ring cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, W, Hkv, hd). ``slot_pos`` holds
    the absolute position stored in each ring entry (-1 = empty): (W,) for
    a cache whose rows share one position ``q_pos`` (a scalar), or (B, W)
    with ``q_pos`` (B,) for per-slot rows (continuous batching).
    """
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd)
    qp = q_pos[..., None]
    m = (slot_pos >= 0) & (slot_pos <= qp)
    if window is not None:
        m &= (qp - slot_pos) < window
    m = m.reshape(-1, 1, 1, 1, m.shape[-1])          # (B|1, 1, 1, 1, W)
    out = _grouped_attn(qg, k_cache, v_cache, m)
    return out.reshape(B, 1, H, hd)


def _qkv(p: dict, cfg, x: torch.Tensor):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def check_positions(positions, S: int) -> None:
    """The flash kernel attends on absolute indices ``0..S-1`` on both
    sides, so a sequence pass takes no other positions."""
    if positions is None:
        return
    pos = torch.as_tensor(positions).cpu()
    if not torch.equal(pos, torch.arange(S, dtype=pos.dtype)):
        raise ValueError(f"sequence attention takes positions arange({S}) "
                         f"only (the flash kernel's absolute indices), got "
                         f"{pos.tolist()[:8]}...")


def gqa_forward(p: dict, cfg, x: torch.Tensor, positions=None,
                window: Optional[int] = None):
    """x: (B,S,D), positions: None or arange(S) -> ((B,S,D), (k, v)).
    No cache."""
    B, S, _ = x.shape
    check_positions(positions, S)
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention(q, k, v, window=window or cfg.sliding_window)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def gqa_decode(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor,
               cache_kv: dict, slot_pos: torch.Tensor,
               window: Optional[int] = None):
    """x: (B,1,D); cache_kv: dict(k=(B,W,Hkv,hd), v=...), written in place
    at entry ``pos % W`` of each row; ``pos`` is a scalar or (B,), and
    ``slot_pos`` ((W,) or (B, W)) already includes ``pos``."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    pos_arr = pos.reshape(-1, 1) if pos.dim() else pos.reshape(1)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    W = cache_kv["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    idx = (pos % W).expand(B)
    cache_kv["k"][rows, idx] = k[:, 0]
    cache_kv["v"][rows, idx] = v[:, 0]
    out = cache_attention(q, cache_kv["k"], cache_kv["v"], pos, slot_pos,
                          window=window or cfg.sliding_window)
    return out.reshape(B, 1, -1) @ p["wo"], cache_kv

"""Attention: grouped-query attention (GQA) with a ring-buffer KV cache.

The port of the GQA part of the JAX package's ``models/attention.py``.
A sequence pass (:func:`gqa_forward`) takes one of two routes:

* ``attention="flash"`` (serving's prefill, the policy's rollouts): the
  flash-attention kernel (``kernels/flash_attention``), forward only, on
  positions ``arange(S)``;
* ``attention="chunked"`` (training): :func:`chunked_causal_attention`,
  the reference's own route, plain tensor code that autograd
  differentiates, on any positions.

Single-token decode (:func:`cache_attention`) is plain tensor code, as in
the reference. Layouts are the reference's: (B, S, H, hd) for attention
and (B, W, Hkv, hd) for a layer's ring cache. Multi-head latent attention
(MLA) waits for a later slice (ROADMAP Queue 1).

Unlike the reference, :func:`gqa_decode` writes the new token's K and V
into the cache it is given, in place, and returns that cache: the port
keeps one copy of the ring instead of a new one per step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init

# finite, never -inf: a padded query row masks every key, and its uniform
# softmax over -1e30 stays finite (and gets zero gradient once sliced off)
NEG_INF = -1e30
#: the values of ``attention=`` that a sequence pass takes
ATTENTION_ROUTES = ("flash", "chunked")


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


def _chunk_attention(qi: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pi: torch.Tensor, k_pos: torch.Tensor,
                     window: Optional[int]) -> torch.Tensor:
    """One query chunk: qi (B, c, H, hd), k/v (B, Sk, H, hd) -> (B, c, H,
    hd), f32 scores, softmax over the keys."""
    m = pi[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (pi[:, None] - k_pos[None, :]) < window
    s = torch.einsum("bqhd,bkhd->bhqk", qi.float(), k.float()) \
        * (qi.shape[-1] ** -0.5)
    s = torch.where(m, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_pos, k_pos,
                             window: Optional[int] = None,
                             chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over query chunks: the
    reference's training route.

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd); q_pos: (Sq,), k_pos: (Sk,),
    any positions. KV heads are repeated to H (head h reads KV head h //
    G), their gradients summed over each group in a fixed order. Queries
    are padded to whole chunks with position -1, which masks every key.
    Each chunk's scores are (B, H, chunk, Sk), and each chunk is
    checkpointed while autograd records, as the reference's
    ``jax.checkpoint`` does, so the backward holds one chunk's scores at a
    time.
    """
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        # jnp.repeat on axis 2, as an expand: its backward sums each
        # group's G heads in a fixed order, where repeat_interleave's
        # index_add on the card sums them in the order atomics land
        k, v = (x[:, :, :, None].expand(*x.shape[:3], G, hd).reshape(
            x.shape[0], x.shape[1], H, hd) for x in (k, v))
    q_pos = torch.as_tensor(q_pos, device=q.device)
    k_pos = torch.as_tensor(k_pos, device=q.device)
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    recording = torch.is_grad_enabled()
    outs = []
    for lo in range(0, q.shape[1], chunk):
        args = (q[:, lo:lo + chunk], k, v, q_pos[lo:lo + chunk], k_pos,
                window)
        outs.append(checkpoint(_chunk_attention, *args, use_reentrant=False)
                    if recording else _chunk_attention(*args))
    return torch.cat(outs, dim=1)[:, :Sq]


def check_positions(positions, S: int) -> None:
    """The flash kernel attends on absolute indices ``0..S-1`` on both
    sides, so its route takes no other positions."""
    if positions is None:
        return
    pos = torch.as_tensor(positions).cpu()
    if not torch.equal(pos, torch.arange(S, dtype=pos.dtype)):
        raise ValueError(f"the flash route takes positions arange({S}) "
                         f"only (the kernel's absolute indices), got "
                         f"{pos.tolist()[:8]}...; attention='chunked' takes "
                         f"any")


def check_route(attention: str) -> None:
    if attention not in ATTENTION_ROUTES:
        raise ValueError(f"attention must be one of {ATTENTION_ROUTES}, "
                         f"got {attention!r}")


def gqa_forward(p: dict, cfg, x: torch.Tensor, positions=None,
                window: Optional[int] = None, attention: str = "flash"):
    """x: (B,S,D) -> ((B,S,D), (k, v)). No cache. ``attention="flash"``
    runs the flash op on positions None or ``arange(S)``;
    ``attention="chunked"`` runs :func:`chunked_causal_attention` on any
    ``positions`` (default ``arange(S)``)."""
    check_route(attention)
    B, S, _ = x.shape
    if attention == "flash":
        check_positions(positions, S)
        positions = None
    pos = torch.arange(S, device=x.device) if positions is None \
        else torch.as_tensor(positions, device=x.device)
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = window or cfg.sliding_window
    if attention == "flash":
        out = flash_attention(q, k, v, window=window)
    else:
        out = chunked_causal_attention(q, k, v, pos, pos, window=window)
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

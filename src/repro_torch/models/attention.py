"""Attention: grouped-query attention (GQA) and multi-head latent
attention (MLA), with ring-buffer caches.

The port of the JAX package's ``models/attention.py``. A GQA sequence
pass (:func:`gqa_forward`) takes one of two routes:

* ``attention="flash"`` (serving's prefill, the policy's rollouts): the
  flash-attention kernel (``kernels/flash_attention``), forward only, on
  positions ``arange(S)``;
* ``attention="chunked"`` (training): :func:`chunked_causal_attention`,
  the reference's own route, plain tensor code that autograd
  differentiates, on any positions.

Single-token decode (:func:`cache_attention`) is plain tensor code, as in
the reference. Layouts are the reference's: (B, S, H, hd) for attention
and (B, W, Hkv, hd) for a layer's ring cache.

MLA (:func:`mla_forward`, :func:`mla_decode`) caches the compressed
latent ``c`` (B, W, kv_lora_rank) and the shared RoPE key ``k_rope`` (B,
W, qk_rope_head_dim). Its sequence pass takes the same two routes:
``attention="flash"`` (serving's prefill) hands q (B, S, H, qk_nope +
qk_rope) and the K and V expanded from the latent to the flash kernel,
whose v head dim is its own (DeepSeek-V2-Lite's 192/128 on the kernel's
hd-192 instance, MiniCPM3-4B's 96/64 on the hd-128 one);
``attention="chunked"`` (training) is the reference's route. Its decode
(:func:`mla_decode`) is plain tensor code, as in the reference.

Unlike the reference, the decode steps write the new token's entries
into the cache they are given, in place, and return that cache: the port
keeps one copy of the ring instead of a new one per step.
"""
from __future__ import annotations

from typing import Callable, Optional

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


def init_mla(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """MLA's projections: the latent down-projection ``w_dkv`` (d, r +
    rope), the up-projections ``w_uk`` (r, H·nope) and ``w_uv`` (r, H·v),
    ``wo``, and the query's low-rank pair ``w_dq``/``w_uq`` when
    ``q_lora_rank`` is set, else one ``wq`` (d, H·(nope + rope))."""
    return {name: dense_init(generator, shape, dtype)
            for name, shape in mla_shapes(cfg).items()}


def mla_shapes(cfg) -> dict:
    """The shapes of :func:`init_mla`'s tree."""
    a = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_hd = a.qk_nope_head_dim + a.qk_rope_head_dim
    shapes = {"w_dkv": (d, a.kv_lora_rank + a.qk_rope_head_dim),
              "w_uk": (a.kv_lora_rank, H * a.qk_nope_head_dim),
              "w_uv": (a.kv_lora_rank, H * a.v_head_dim),
              "wo": (H * a.v_head_dim, d)}
    if a.q_lora_rank:
        shapes["w_dq"] = (d, a.q_lora_rank)
        shapes["w_uq"] = (a.q_lora_rank, H * qk_hd)
    else:
        shapes["wq"] = (d, H * qk_hd)
    return shapes


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


def _qkv(p: dict, cfg, x: torch.Tensor, x_kv: Optional[torch.Tensor] = None):
    """The projections: q from ``x``, k and v from ``x_kv`` (default
    ``x``)."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    q = x @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
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

    q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v), where
    hd_v may differ from hd (MLA); q_pos: (Sq,), k_pos: (Sk,), any
    positions. KV heads are repeated to H (head h reads KV head h // G),
    their gradients summed over each group in a fixed order. Queries
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
        k, v = (x[:, :, :, None].expand(*x.shape[:3], G, x.shape[-1])
                .reshape(x.shape[0], x.shape[1], H, x.shape[-1])
                for x in (k, v))
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
    # analysis: host-side (checks caller-given positions, before any kernel)
    pos = torch.as_tensor(positions).cpu()
    if not torch.equal(pos, torch.arange(S, dtype=pos.dtype)):
        raise ValueError(f"the flash route takes positions arange({S}) "
                         f"only (the kernel's absolute indices), got "
                         # analysis: host-side (the error's message)
                         f"{pos.tolist()[:8]}...; attention='chunked' takes "
                         f"any")


def check_route(attention: str) -> None:
    if attention not in ATTENTION_ROUTES:
        raise ValueError(f"attention must be one of {ATTENTION_ROUTES}, "
                         f"got {attention!r}")


def kv_heads_for(cfg, lo: int, hi: int) -> torch.Tensor:
    """The KV heads that query heads ``[lo, hi)`` read, as an index into
    all ``cfg.n_kv_heads`` in GQA's grouping: with n entries, local query
    head j reads entry j // ((hi − lo) / n). The heads themselves where
    each serves the same number of the block's query heads, else one
    entry per query head (n = hi − lo), where the block starts or ends
    inside a KV group."""
    G = cfg.n_heads // cfg.n_kv_heads
    need = [h // G for h in range(lo, hi)]
    heads = sorted(set(need))
    g = len(need) // len(heads)
    if len(need) % len(heads) or need != [h for h in heads
                                          for _ in range(g)]:
        heads = need
    return torch.tensor(heads, dtype=torch.long)


def _read(k: torch.Tensor, v: torch.Tensor, kv_heads):
    """The KV heads (dimension 2) that the query heads read."""
    if kv_heads is None:
        return k, v
    idx = kv_heads.to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def gqa_forward(p: dict, cfg, x: torch.Tensor, positions=None,
                window: Optional[int] = None, attention: str = "flash",
                kv_heads: Optional[torch.Tensor] = None,
                enter: Optional[Callable] = None):
    """x: (B,S,D) -> ((B,S,D), (k, v)). No cache. ``attention="flash"``
    runs the flash op on positions None or ``arange(S)``;
    ``attention="chunked"`` runs :func:`chunked_causal_attention` on any
    ``positions`` (default ``arange(S)``). ``kv_heads``
    (:func:`kv_heads_for`): the query heads attend to these of the
    ``cfg.n_kv_heads`` computed, and (k, v) keep them all.

    ``enter`` (a rank's block of the heads under autograd, whose output
    is its part of a sum): what every rank holds alike enters the
    rank's heads through it, so that the backward sums the ranks'
    partial gradients: ``x`` before the projections of the rank's heads
    and, where K and V are computed for every KV head (``kv_heads``),
    those K and V."""
    check_route(attention)
    B, S, _ = x.shape
    if attention == "flash":
        check_positions(positions, S)
        positions = None
    pos = torch.arange(S, device=x.device) if positions is None \
        else torch.as_tensor(positions, device=x.device)
    if enter is None:
        q, k, v = _qkv(p, cfg, x)
    elif kv_heads is None:
        q, k, v = _qkv(p, cfg, enter(x))
    else:
        q, k, v = _qkv(p, cfg, enter(x), x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = window or cfg.sliding_window
    if enter is not None and kv_heads is not None:
        ka, va = _read(enter(k), enter(v), kv_heads)
    else:
        ka, va = _read(k, v, kv_heads)
    if attention == "flash":
        out = flash_attention(q, ka, va, window=window)
    else:
        out = chunked_causal_attention(q, ka, va, pos, pos, window=window)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def gqa_decode(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor,
               cache_kv: dict, slot_pos: torch.Tensor,
               window: Optional[int] = None,
               kv_heads: Optional[torch.Tensor] = None):
    """x: (B,1,D); cache_kv: dict(k=(B,W,Hkv,hd), v=...), written in place
    at entry ``pos % W`` of each row; ``pos`` is a scalar or (B,), and
    ``slot_pos`` ((W,) or (B, W)) already includes ``pos``. ``kv_heads``
    as in :func:`gqa_forward`."""
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
    out = cache_attention(q, *_read(cache_kv["k"], cache_kv["v"], kv_heads),
                          pos, slot_pos, window=window or cfg.sliding_window)
    return out.reshape(B, 1, -1) @ p["wo"], cache_kv


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _mla_q(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
           enter: Callable = _identity):
    """x (B, S, D) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope)
    rotated at ``positions``; the heads' input (``x``, or ``x @ w_dq``)
    goes through ``enter``."""
    a = cfg.mla
    B, S, _ = x.shape
    if a.q_lora_rank:
        q = enter(x @ p["w_dq"]) @ p["w_uq"]
    else:
        q = enter(x) @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, a.qk_nope_head_dim + a.qk_rope_head_dim)
    q_nope = q[..., :a.qk_nope_head_dim]
    q_rope = apply_rope(q[..., a.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                enter: Callable = _identity):
    """x (B, S, D) -> the latent c (B, S, r) and the shared RoPE key
    k_rope (B, S, rope) rotated at ``positions``; ``x @ w_dkv`` goes
    through ``enter``."""
    a = cfg.mla
    ckv = enter(x @ p["w_dkv"])                       # (B, S, r + rope)
    c = ckv[..., :a.kv_lora_rank]
    k_rope = apply_rope(ckv[..., None, a.kv_lora_rank:], positions,
                        cfg.rope_theta)               # (B, S, 1, rope)
    return c, k_rope[..., 0, :]


def mla_forward(p: dict, cfg, x: torch.Tensor, positions=None,
                window: Optional[int] = None, attention: str = "flash",
                enter: Callable = _identity):
    """x: (B,S,D) -> ((B,S,D), (c, k_rope)). K and V are expanded from
    the latent and attended with q/k head dim nope + rope and v head dim
    ``v_head_dim``: ``attention="flash"`` by the flash op on positions
    None or ``arange(S)`` (forward only), ``attention="chunked"`` by
    :func:`chunked_causal_attention` on any ``positions`` (default
    ``arange(S)``). ``window`` alone sets the window: as in the
    reference, ``cfg.sliding_window`` is not read here
    (:func:`gqa_forward` reads it).

    ``enter`` (a rank's block of the heads under autograd, as in
    :func:`gqa_forward`): the heads' query input (``x``, or ``x @
    w_dq``) and the latent ``x @ w_dkv`` enter the rank's heads through
    it, so ``w_dq``'s and ``w_dkv``'s gradients, which every rank
    computes whole, sum the ranks' partial gradients."""
    check_route(attention)
    a = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    if attention == "flash":
        check_positions(positions, S)
        positions = None
    pos = torch.arange(S, device=x.device) if positions is None \
        else torch.as_tensor(positions, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos, enter)
    c, k_rope = _mla_latent(p, cfg, x, pos, enter)
    k_nope = (c @ p["w_uk"]).reshape(B, S, H, a.qk_nope_head_dim)
    v = (c @ p["w_uv"]).reshape(B, S, H, a.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        B, S, H, a.qk_rope_head_dim)], dim=-1)
    if attention == "flash":
        out = flash_attention(q, k, v, window=window)
    else:
        out = chunked_causal_attention(q, k, v, pos, pos, window=window)
    return out.reshape(B, S, -1) @ p["wo"], (c, k_rope)


def mla_decode(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor,
               cache: dict, slot_pos: torch.Tensor,
               window: Optional[int] = None, absorb: bool = True):
    """Latent-cache decode. x: (B,1,D); cache: dict(c=(B,W,r),
    k_rope=(B,W,rope)), written in place at entry ``pos % W`` of each
    row; ``pos`` is a scalar or (B,), and ``slot_pos`` ((W,) or (B, W))
    already includes ``pos``.

    ``absorb=True`` folds ``w_uk`` into the query and ``w_uv`` into the
    output (DeepSeek's weight absorption), so a step attends over the
    latent, O(W·(r + rope)·H), instead of expanding K and V from it."""
    a = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos_arr = pos.reshape(-1, 1) if pos.dim() else pos.reshape(1)
    q_nope, q_rope = _mla_q(p, cfg, x, pos_arr)       # (B, 1, H, *)
    c_t, kr_t = _mla_latent(p, cfg, x, pos_arr)
    W = cache["c"].shape[1]
    rows = torch.arange(B, device=x.device)
    idx = (pos % W).expand(B)
    cache["c"][rows, idx] = c_t[:, 0]
    cache["k_rope"][rows, idx] = kr_t[:, 0]
    c, k_rope = cache["c"], cache["k_rope"]
    qp = pos[..., None]
    m = (slot_pos >= 0) & (slot_pos <= qp)
    if window is not None:
        m &= (qp - slot_pos) < window
    m = m.reshape(-1, 1, 1, W)                        # (B|1, 1, 1, W)

    scale = (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
    if absorb:
        w_uk = p["w_uk"].reshape(a.kv_lora_rank, H, a.qk_nope_head_dim)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
        s = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c.float())
        s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             k_rope.float())
        s = torch.where(m, s * scale, NEG_INF)
        w = torch.softmax(s, dim=-1).to(c.dtype)
        o_lat = torch.einsum("bhqk,bkr->bqhr", w, c)
        w_uv = p["w_uv"].reshape(a.kv_lora_rank, H, a.v_head_dim)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
    else:
        k_nope = (c @ p["w_uk"]).reshape(B, W, H, a.qk_nope_head_dim)
        v = (c @ p["w_uv"]).reshape(B, W, H, a.v_head_dim)
        s = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
        s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             k_rope.float())
        s = torch.where(m, s * scale, NEG_INF)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out.reshape(B, 1, -1) @ p["wo"], cache

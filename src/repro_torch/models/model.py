"""Decoder model: init / forward / prefill / decode for the dense GQA
families, with per-layer parameters stacked along a leading layer axis.

The port of the JAX package's ``models/model.py`` for the ``dense``,
``vlm`` and ``audio`` families (the same block; vlm and audio prepend
projected prefix embeddings):

    [norm -> GQA -> +res -> norm -> SwiGLU -> +res] x n_layers

Parameters are nested dicts of tensors in the reference's layout (blocks
stacked ``(L, ...)``), so JAX weights carry over leaf for leaf
(:func:`repro_torch.convert.model_params_from_jax`). The ``moe``,
``hybrid`` and ``ssm`` families and multi-head latent attention raise
``NotImplementedError``: they wait for later slices (ROADMAP Queue 1).
The losses wait for the training slice.

Caches are ring buffers whose size is the attention window. Decode
writes into the cache it is given, in place (the reference returns a new
one), and returns it with the position advanced.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, init_swiglu, rms_norm,
                                       swiglu)

#: families this slice ports (the dense block, with or without a prefix
#: frontend)
FAMILIES = ("dense", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention is not ported yet "
            f"(ROADMAP Queue 1, the MoE, MLA, hybrid and SSM families)")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1, the MoE, MLA, hybrid and SSM families)")


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, generator: torch.Generator, dtype) -> dict:
    d = cfg.d_model
    dev = generator.device
    return {"norm_attn": torch.ones((d,), dtype=dtype, device=dev),
            "norm_mlp": torch.ones((d,), dtype=dtype, device=dev),
            "attn": attn.init_gqa(generator, cfg, dtype),
            "mlp": init_swiglu(generator, d, cfg.d_ff, dtype)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The shapes of :func:`init_params`'s tree, without drawing it."""
    check_supported(cfg)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    attn_shapes = {"wq": (L, d, cfg.n_heads * hd),
                   "wk": (L, d, cfg.n_kv_heads * hd),
                   "wv": (L, d, cfg.n_kv_heads * hd),
                   "wo": (L, cfg.n_heads * hd, d)}
    if cfg.qkv_bias:
        attn_shapes.update(bq=(L, cfg.n_heads * hd),
                           bk=(L, cfg.n_kv_heads * hd),
                           bv=(L, cfg.n_kv_heads * hd))
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
              "blocks": {"norm_attn": (L, d), "norm_mlp": (L, d),
                         "attn": attn_shapes,
                         "mlp": {"w_gate": (L, d, cfg.d_ff),
                                 "w_up": (L, d, cfg.d_ff),
                                 "w_down": (L, cfg.d_ff, d)}}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    if cfg.frontend != "none":
        shapes["frontend_proj"] = (d, d)
    return shapes


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, key, dtype=torch.float32,
                device=None) -> dict:
    """Random parameters. ``key`` is a ``torch.Generator`` (draws on its
    device) or an int seed (a generator on ``device``); the result lies on
    ``device`` (default CUDA, see :func:`repro_torch.resolve_device`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    d = cfg.d_model
    params = {
        "embed": 0.02 * torch.randn((cfg.vocab_size, d), generator=gen,
                                    device=gen.device).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=gen.device),
    }
    params["blocks"] = _stack([_init_block(cfg, gen, dtype)
                               for _ in range(cfg.n_layers)])
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype)
    if cfg.frontend != "none":
        params["frontend_proj"] = dense_init(gen, (d, d), dtype)
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """tokens: (B, S_text) int; prefix_embeds: (B, P, D) or None."""
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([pe, x], dim=1)
    return x


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w


def _layer(blocks: dict, i: int) -> dict:
    return tree_map(lambda t: t[i], blocks)


# ---------------------------------------------------------------------------
# Sequence forward (prefill)
# ---------------------------------------------------------------------------

def _block_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
               window: Optional[int]):
    """One block over a full sequence. Returns (x, cache_parts, aux)."""
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps, cfg.fused_rmsnorm)
    a_out, kv = attn.gqa_forward(p["attn"], cfg, h, positions, window=window)
    x = x + a_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps, cfg.fused_rmsnorm)
    m_out = swiglu(h, **p["mlp"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m_out, {"kv": {"k": kv[0], "v": kv[1]}}, aux


def forward(cfg: ModelConfig, params: dict, tokens=None, prefix_embeds=None,
            positions=None, window: Optional[int] = None,
            collect_cache: bool = False, last_only: bool = False):
    """Full-sequence forward. Returns (logits, aux, cache_parts|None);
    cache_parts are stacked over layers, ``{"kv": {"k": (L, B, S, Hkv,
    hd), "v": ...}}``. ``positions`` may only be ``arange(S)`` (the flash
    kernel's absolute indices)."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    attn.check_positions(positions, x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, cache, a = _block_seq(cfg, _layer(params["blocks"], i), x, None,
                                 window)
        aux = aux + a
        if collect_cache:
            ks.append(cache["kv"]["k"])
            vs.append(cache["kv"]["v"])
    caches = ({"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
              if collect_cache else None)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.fused_rmsnorm)
    return lm_logits(cfg, params, x), aux, caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Empty decode cache; ``cache_len`` is the KV ring size."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((), dtype=torch.long, device=dev),
            "slot_pos": torch.full((cache_len,), -1, dtype=torch.long,
                                   device=dev),
            "blocks": {"kv": {"k": torch.zeros(shape, dtype=dtype,
                                               device=dev),
                              "v": torch.zeros(shape, dtype=dtype,
                                               device=dev)}}}


def prefill(cfg: ModelConfig, params: dict, tokens=None, prefix_embeds=None,
            cache_len: Optional[int] = None, window: Optional[int] = None,
            last_only: bool = True):
    """Run the prompt, build the decode cache. Returns (logits, cache)."""
    logits, _, caches = forward(cfg, params, tokens, prefix_embeds,
                                window=window, collect_cache=True,
                                last_only=last_only)
    S = (tokens.shape[1] if tokens is not None else 0) + \
        (prefix_embeds.shape[1] if prefix_embeds is not None else 0)
    cache_len = cache_len or S
    dev = logits.device

    def fit(x):
        # the sequence axis is axis 2 of the stacked (L, B, S, Hkv, hd)
        if S >= cache_len:
            return x[:, :, S - cache_len:]
        pad = torch.zeros(x.shape[:2] + (cache_len - S,) + x.shape[3:],
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=2)

    kv = tree_map(fit, caches["kv"])
    keep = min(S, cache_len)
    slot_pos = torch.full((cache_len,), -1, dtype=torch.long, device=dev)
    slot_pos[:keep] = torch.arange(S - keep, S, device=dev)
    # ring alignment: the next write goes to S % cache_len, which must be
    # the oldest entry, so a full ring is rolled by S % cache_len
    if keep == cache_len:
        roll = S % cache_len
        kv = tree_map(lambda x: torch.roll(x, roll, dims=2), kv)
        slot_pos = torch.roll(slot_pos, roll)
    return logits, {"pos": torch.tensor(S, dtype=torch.long, device=dev),
                    "slot_pos": slot_pos, "blocks": {"kv": kv}}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  pos: torch.Tensor, slot_pos: torch.Tensor, cache: dict):
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps, cfg.fused_rmsnorm)
    a_out, new_kv = attn.gqa_decode(p["attn"], cfg, h, pos, cache["kv"],
                                    slot_pos)
    x = x + a_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps, cfg.fused_rmsnorm)
    return x + swiglu(h, **p["mlp"]), {"kv": new_kv}


def _decode_layers(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   pos: torch.Tensor, slot_pos: torch.Tensor,
                   blocks: dict) -> torch.Tensor:
    for i in range(cfg.n_layers):
        x, _ = _block_decode(cfg, _layer(params["blocks"], i), x, pos,
                             slot_pos, _layer(blocks, i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.fused_rmsnorm)
    return lm_logits(cfg, params, x)


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict):
    """token: (B,) or (B,1) int. Returns (logits (B,1,V), cache): the
    cache's ring and ``slot_pos`` are written in place, ``pos`` is a new
    tensor one further."""
    check_supported(cfg)
    if token.dim() == 1:
        token = token[:, None]
    x = params["embed"][token]
    pos = cache["pos"]
    slot_pos = cache["slot_pos"]
    slot_pos[pos % slot_pos.shape[0]] = pos
    logits = _decode_layers(cfg, params, x, pos, slot_pos, cache["blocks"])
    return logits, {"pos": pos + 1, "slot_pos": slot_pos,
                    "blocks": cache["blocks"]}


# ---------------------------------------------------------------------------
# Per-slot decode (continuous-batching serving)
# ---------------------------------------------------------------------------

def init_slot_cache(cfg: ModelConfig, slots: int, cache_len: int,
                    dtype=torch.float32, device=None) -> dict:
    """Empty per-slot decode cache: like :func:`init_cache`, but every
    batch row is an independent serving slot with its own write position:
    ``pos`` is ``(slots,)`` and ``slot_pos`` is ``(slots, cache_len)``."""
    cache = init_cache(cfg, slots, cache_len, dtype, device)
    dev = cache["pos"].device
    return {"pos": torch.zeros((slots,), dtype=torch.long, device=dev),
            "slot_pos": torch.full((slots, cache_len), -1, dtype=torch.long,
                                   device=dev),
            "blocks": cache["blocks"]}


def decode_step_slots(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                      cache: dict):
    """One decode step over a per-slot cache (:func:`init_slot_cache`).

    ``tokens``: ``(slots,)`` int; each slot advances at its own position.
    The reference vmaps :func:`decode_step` over slots; here the slot is
    an explicit batch dimension whose rows carry their own ``pos`` and
    ``slot_pos``, so a slot's logits depend only on its own ring. Returns
    ``(logits (slots, V), cache)``, the cache updated in place as in
    :func:`decode_step`."""
    check_supported(cfg)
    x = params["embed"][tokens][:, None]                 # (slots, 1, D)
    pos = cache["pos"]
    slot_pos = cache["slot_pos"]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    slot_pos[rows, pos % slot_pos.shape[1]] = pos
    logits = _decode_layers(cfg, params, x, pos, slot_pos, cache["blocks"])
    return logits[:, 0], {"pos": pos + 1, "slot_pos": slot_pos,
                          "blocks": cache["blocks"]}

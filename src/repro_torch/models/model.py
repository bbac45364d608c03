"""Decoder model: init / forward / prefill / decode for the attention
families, with per-layer parameters stacked along a leading layer axis.

The port of the JAX package's ``models/model.py`` for the ``dense``,
``vlm``, ``audio`` and ``moe`` families (vlm and audio prepend projected
prefix embeddings):

    [norm -> GQA|MLA -> +res -> norm -> SwiGLU|MoE -> +res] x n_layers

Parameters are nested dicts of tensors in the reference's layout (blocks
stacked ``(L, ...)``), so JAX weights carry over leaf for leaf
(:func:`repro_torch.convert.model_params_from_jax`). The recurrent
``hybrid`` and ``ssm`` families raise ``NotImplementedError``: they wait
for a later slice (ROADMAP Queue 1).

A GQA sequence pass takes one of two attention routes
(:mod:`repro_torch.models.attention`): ``attention="flash"``, the
forward-only kernel that serving's prefill runs, or
``attention="chunked"``, the reference's plain route that autograd
differentiates. MLA takes the chunked route on both. The losses
(:func:`lm_loss`, :func:`lm_loss_labeled`) are the training route and
run the second.

Caches are ring buffers whose size is the attention window, holding K
and V per layer (GQA) or MLA's latent ``c`` and RoPE key. Decode
writes into the cache it is given, in place (the reference returns a new
one), and returns it with the position advanced.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_paths
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (dense_init, init_swiglu, rms_norm,
                                       swiglu)

#: families the port serves: the attention block (GQA or MLA, SwiGLU or
#: MoE), with or without a prefix frontend
FAMILIES = ("dense", "vlm", "audio", "moe")


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1, the hybrid and SSM families)")


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
            "attn": (attn.init_mla(generator, cfg, dtype)
                     if cfg.mla is not None
                     else attn.init_gqa(generator, cfg, dtype)),
            "mlp": (moe_lib.init_moe(generator, cfg, dtype)
                    if cfg.moe is not None
                    else init_swiglu(generator, d, cfg.d_ff, dtype))}


def param_shapes(cfg: ModelConfig) -> dict:
    """The shapes of :func:`init_params`'s tree, without drawing it."""
    check_supported(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.mla is not None:
        attn_shapes = attn.mla_shapes(cfg)
    else:
        attn_shapes = {"wq": (d, cfg.n_heads * hd),
                       "wk": (d, cfg.n_kv_heads * hd),
                       "wv": (d, cfg.n_kv_heads * hd),
                       "wo": (cfg.n_heads * hd, d)}
        if cfg.qkv_bias:
            attn_shapes.update(bq=(cfg.n_heads * hd,),
                               bk=(cfg.n_kv_heads * hd,),
                               bv=(cfg.n_kv_heads * hd,))
    mlp_shapes = (moe_lib.moe_shapes(cfg) if cfg.moe is not None
                  else {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                        "w_down": (cfg.d_ff, d)})
    block = {"norm_attn": (d,), "norm_mlp": (d,), "attn": attn_shapes,
             "mlp": mlp_shapes}
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
              "blocks": tree_map(lambda s: (cfg.n_layers,) + s, block)}
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
               window: Optional[int], attention: str):
    """One block over a full sequence. Returns (x, cache_parts, aux)."""
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps, cfg.fused_rmsnorm)
    if cfg.mla is not None:
        a_out, kv = attn.mla_forward(p["attn"], cfg, h, positions,
                                     window=window)
        cache = {"c": kv[0], "k_rope": kv[1]}
    else:
        a_out, kv = attn.gqa_forward(p["attn"], cfg, h, positions,
                                     window=window, attention=attention)
        cache = {"k": kv[0], "v": kv[1]}
    x = x + a_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps, cfg.fused_rmsnorm)
    if cfg.moe is not None:
        m_out, aux = moe_lib.moe_forward(p["mlp"], cfg, h)
    else:
        m_out = swiglu(h, **p["mlp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m_out, {"kv": cache}, aux


def forward(cfg: ModelConfig, params: dict, tokens=None, prefix_embeds=None,
            positions=None, window: Optional[int] = None,
            collect_cache: bool = False, remat: bool = True,
            last_only: bool = False, attention: str = "flash"):
    """Full-sequence forward. Returns (logits, aux, cache_parts|None);
    cache_parts are stacked over layers, ``{"kv": {"k": (L, B, S, Hkv,
    hd), "v": ...}}`` (GQA) or ``{"kv": {"c": (L, B, S, r), "k_rope": (L,
    B, S, rope)}}`` (MLA). ``aux`` sums the MoE load-balance term over
    layers (0 without MoE).

    ``attention="flash"`` (serving's route) takes ``positions`` None or
    ``arange(S)`` only (the kernel's absolute indices) and has no
    backward; ``attention="chunked"`` (the training route) takes any
    ``positions``. MLA layers take the chunked route on both: the flash
    kernel needs equal q/k/v head dims up to 128, and MLA's differ
    (DeepSeek-V2-Lite's q/k 192, v 128). ``remat`` checkpoints each
    layer while autograd records (recomputed in the backward, as the
    reference's ``jax.checkpoint`` of its layer scan); when it does not
    record, it changes nothing."""
    check_supported(cfg)
    attn.check_route(attention)
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    if attention == "flash":
        attn.check_positions(positions, x.shape[1])
        positions = None
    recording = remat and torch.is_grad_enabled() and (
        x.requires_grad
        or any(t.requires_grad for _, t in tree_paths(params["blocks"])))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = []
    for i in range(cfg.n_layers):
        args = (cfg, _layer(params["blocks"], i), x, positions, window,
                attention)
        x, cache, a = (checkpoint(_block_seq, *args, use_reentrant=False)
                       if recording else _block_seq(*args))
        aux = aux + a
        if collect_cache:
            layers.append(cache)
    caches = _stack(layers) if collect_cache else None
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.fused_rmsnorm)
    return lm_logits(cfg, params, x), aux, caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Empty decode cache; ``cache_len`` is the ring size. Per layer it
    holds K and V (L, B, W, Hkv, hd), or MLA's latent ``c`` (L, B, W,
    kv_lora_rank) and ``k_rope`` (L, B, W, qk_rope_head_dim)."""
    check_supported(cfg)
    dev = resolve_device(device)
    lead = (cfg.n_layers, batch, cache_len)
    if cfg.mla is not None:
        shapes = {"c": lead + (cfg.mla.kv_lora_rank,),
                  "k_rope": lead + (cfg.mla.qk_rope_head_dim,)}
    else:
        shapes = dict.fromkeys(("k", "v"), lead + (cfg.n_kv_heads,
                                                   cfg.resolved_head_dim))
    return {"pos": torch.zeros((), dtype=torch.long, device=dev),
            "slot_pos": torch.full((cache_len,), -1, dtype=torch.long,
                                   device=dev),
            "blocks": {"kv": {name: torch.zeros(shape, dtype=dtype,
                                                device=dev)
                              for name, shape in shapes.items()}}}


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
        # the sequence axis is axis 2 of every stacked (L, B, S, ...) leaf
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
    if cfg.mla is not None:
        # no window, as in the reference's MLA decode
        a_out, new_kv = attn.mla_decode(p["attn"], cfg, h, pos, cache["kv"],
                                        slot_pos, absorb=cfg.mla_absorb)
    else:
        a_out, new_kv = attn.gqa_decode(p["attn"], cfg, h, pos,
                                        cache["kv"], slot_pos)
    x = x + a_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps, cfg.fused_rmsnorm)
    if cfg.moe is not None:
        # each batch row (each slot) routes its one token alone
        m_out, _ = moe_lib.moe_forward(p["mlp"], cfg, h)
    else:
        m_out = swiglu(h, **p["mlp"])
    return x + m_out, {"kv": new_kv}


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


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Mean over every position of logsumexp(logits) minus the label's
    logit, in f32. The reference picks the label's logit with an iota
    compare and a sum over the vocabulary (so that vocab-sharded logits
    are never gathered); a gather picks the same value exactly."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - correct)


def lm_loss_labeled(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    labels: torch.Tensor, prefix_embeds=None
                    ) -> torch.Tensor:
    """Cross-entropy of the logits at every token position against
    ``labels`` (+ the aux term), on the chunked (training) route.
    Processes exactly ``tokens.shape[1]`` (+ prefix) positions."""
    logits, aux, _ = forward(cfg, params, tokens, prefix_embeds,
                             attention="chunked")
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    return _cross_entropy(logits[:, P:], labels) + aux


def lm_loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds=None) -> torch.Tensor:
    """Next-token cross-entropy (+ the aux term) on the chunked (training)
    route. tokens: (B, S_text)."""
    logits, aux, _ = forward(cfg, params, tokens[:, :-1], prefix_embeds,
                             attention="chunked")
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    return _cross_entropy(logits[:, P:], tokens[:, 1:]) + aux

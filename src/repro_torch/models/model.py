"""Decoder model: init / forward / prefill / decode for every family,
with per-layer parameters stacked along a leading layer axis.

The port of the JAX package's ``models/model.py``:

    dense / vlm / audio : [norm -> GQA|MLA -> +res -> norm -> SwiGLU -> +res]
    moe                 : as dense, the MLP the sort-dispatch MoE
    hybrid (Hymba)      : [norm -> (GQA + Mamba)/2 -> +res -> norm -> SwiGLU
                           -> +res]
    ssm (xLSTM)         : n_layers / slstm_every pairs of residual
                          [norm -> mLSTM] and [norm -> sLSTM] blocks, no MLP

(vlm and audio prepend projected prefix embeddings). Parameters are
nested dicts of tensors in the reference's layout (blocks stacked ``(L,
...)``, xLSTM's pairs ``(L / slstm_every, ...)``), so JAX weights carry
over leaf for leaf (:func:`repro_torch.convert.model_params_from_jax`).

A GQA sequence pass takes one of two attention routes
(:mod:`repro_torch.models.attention`): ``attention="flash"``, the
forward-only kernel that serving's prefill runs, or
``attention="chunked"``, the reference's plain route that autograd
differentiates; MLA's sequence pass takes the same two. The losses
(:func:`lm_loss`, :func:`lm_loss_labeled`) are the training route and
run the second.

Attention caches are ring buffers whose size is the attention window,
holding K and V per layer (GQA) or MLA's latent ``c`` and RoPE key;
recurrent layers carry O(1) state (Mamba's ``h`` and conv inputs,
mLSTM's C, n, m and conv inputs, sLSTM's h, c, n, m). Decode writes into
the cache it is given, in place (the reference returns a new one): the
new ring entries, and every recurrent state copied over its leaf. It
returns that cache with the position advanced.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_paths
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (dense_init, init_swiglu, rms_norm,
                                       swiglu)


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
    p = {"norm_attn": torch.ones((d,), dtype=dtype, device=dev),
         "norm_mlp": torch.ones((d,), dtype=dtype, device=dev),
         "attn": (attn.init_mla(generator, cfg, dtype)
                  if cfg.mla is not None
                  else attn.init_gqa(generator, cfg, dtype)),
         "mlp": (moe_lib.init_moe(generator, cfg, dtype)
                 if cfg.moe is not None
                 else init_swiglu(generator, d, cfg.d_ff, dtype))}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_mamba(generator, cfg, dtype)
    return p


def _init_xlstm_pair(cfg: ModelConfig, generator: torch.Generator,
                     dtype) -> dict:
    d = cfg.d_model
    dev = generator.device
    return {"m": ssm_lib.init_mlstm(generator, cfg, dtype),
            "s": ssm_lib.init_slstm(generator, cfg, dtype),
            "norm_m": torch.ones((d,), dtype=dtype, device=dev),
            "norm_s": torch.ones((d,), dtype=dtype, device=dev)}


def n_block_stacks(cfg: ModelConfig) -> int:
    """Entries of the stacked block axis: the layers, or xLSTM's
    (mLSTM, sLSTM) pairs."""
    if cfg.family == "ssm":
        return cfg.n_layers // cfg.xlstm.slstm_every
    return cfg.n_layers


def _block_shapes(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.family == "ssm":
        return {"m": ssm_lib.mlstm_shapes(cfg),
                "s": ssm_lib.slstm_shapes(cfg), "norm_m": (d,),
                "norm_s": (d,)}
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
    if cfg.family == "hybrid":
        block["ssm"] = ssm_lib.mamba_shapes(cfg)
    return block


def param_shapes(cfg: ModelConfig) -> dict:
    """The shapes of :func:`init_params`'s tree, without drawing it."""
    d, nb = cfg.d_model, n_block_stacks(cfg)
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
              "blocks": tree_map(lambda s: (nb,) + s, _block_shapes(cfg))}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    if cfg.frontend != "none":
        shapes["frontend_proj"] = (d, d)
    return shapes


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


#: the leaves that :func:`init_params` makes float32 whatever its dtype
_F32_LEAVES = ("router", "A_log", "D")


def _meta_params(shapes: dict, dtype, name: str = "") -> dict:
    if isinstance(shapes, dict):
        return {k: _meta_params(v, dtype, k) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta",
                       dtype=torch.float32 if name in _F32_LEAVES else dtype)


def init_params(cfg: ModelConfig, key, dtype=torch.float32,
                device=None) -> dict:
    """Random parameters. ``key`` is a ``torch.Generator`` (draws on its
    device) or an int seed (a generator on ``device``); the result lies on
    ``device`` (default CUDA, see :func:`repro_torch.resolve_device`). On
    the ``meta`` device: the tree's shapes and dtypes, nothing drawn
    (``key`` unread; the reference's ``jax.eval_shape``)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _meta_params(param_shapes(cfg), dtype)
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
    init_one = _init_xlstm_pair if cfg.family == "ssm" else _init_block
    params["blocks"] = _stack([init_one(cfg, gen, dtype)
                               for _ in range(n_block_stacks(cfg))])
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype)
    if cfg.frontend != "none":
        params["frontend_proj"] = dense_init(gen, (d, d), dtype)
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# A rank's part in a tensor-parallel pass
# ---------------------------------------------------------------------------

def _identity(t):
    return t


@dataclasses.dataclass(frozen=True)
class Parallel:
    """What a route on a mesh hands :func:`forward`, :func:`prefill`,
    :func:`decode_step` and the losses so that their layer loops run on
    one rank's blocks (:func:`repro_torch.distributed.tensor_parallel.
    rank_parallel`: serving's ``make_serve_fns`` and the tree trainer's
    step); the plain route passes None. Autograd goes through every
    collective (:mod:`repro_torch.carriers.placed`).

    * ``layer(i)``: layer i's parameters: the rank's blocks, and the
      leaves gathered whole for the layer;
    * ``psum(t)``: Σ of every rank's partial ``t`` over the "model"
      group, in rank order (the same bits on every rank); its backward
      is the identity;
    * ``enter(t)``: ``t``, which every rank of the group holds alike,
      entering compute split over the group; its backward sums the
      ranks' partial gradients in rank order (psum's conjugate);
    * ``pmax(t)``: the elementwise max over the group (no gradient);
    * ``attn_cfg``: the config attention runs under: the rank's query
      heads and, for GQA, its KV heads or, with ``kv_heads``, all of
      them, of which the queries read those (:func:`repro_torch.models.
      attention.kv_heads_for`); MLA's heads each read their own K and V
      from the latent, which every rank computes whole;
    * ``attn_partial``, ``mlp_partial``, ``shared_partial``: the
      attention's, the MLP's (the routed experts') and the shared
      experts' outputs are the rank's part of a sum;
    * ``experts``: the rank's ``(lo, hi)`` of the experts, or None;
    * ``vocab``: the rank's ``(lo, hi)`` of the vocabulary (the
      embedding's rows, the logits' columns), or None, and
      ``gather_vocab`` puts the logits' columns together;
    * ``keep(i, parts)``: a prefill layer's cache parts, fit to the ring
      -> what the rank keeps of them;
    * ``cache(i, blocks)``: a context that gives decode layer i's cache
      as the layer reads it and writes the new ring entry back on exit.
    """
    layer: Callable
    psum: Callable
    attn_cfg: ModelConfig
    enter: Callable = _identity
    pmax: Optional[Callable] = None
    kv_heads: Optional[torch.Tensor] = None
    attn_partial: bool = False
    mlp_partial: bool = False
    shared_partial: bool = False
    experts: Optional[Tuple[int, int]] = None
    vocab: Optional[Tuple[int, int]] = None
    gather_vocab: Optional[Callable] = None
    keep: Optional[Callable] = None
    cache: Optional[Callable] = None


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None,
                 par: Optional[Parallel] = None) -> torch.Tensor:
    """tokens: (B, S_text) int; prefix_embeds: (B, P, D) or None. Under
    ``par`` with a vocabulary block, ``params["embed"]`` is that block:
    each rank looks up the tokens inside it (zero for the others) and the
    ranks' rows are summed, exactly (one rank adds a value not zero)."""
    if par is None or par.vocab is None:
        x = params["embed"][tokens]
    else:
        lo, hi = par.vocab
        mine = (tokens >= lo) & (tokens < hi)
        x = params["embed"][torch.where(mine, tokens - lo, 0)]
        x = par.psum(torch.where(mine[..., None], x, 0.0))
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([pe, x], dim=1)
    return x


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor,
          par: Optional[Parallel] = None) -> torch.Tensor:
    """x @ the head: under ``par`` with a vocabulary block the rank's
    columns of the logits (x enters the block through ``par.enter``)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if par is not None and par.vocab is not None:
        x = par.enter(x)
    return x @ w


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
              par: Optional[Parallel] = None) -> torch.Tensor:
    """x @ the head. Under ``par`` with a vocabulary block the rank's
    columns, gathered along the vocabulary."""
    out = _head(cfg, params, x, par)
    if par is not None and par.vocab is not None:
        out = par.gather_vocab(out)
    return out


def _layer(blocks: dict, i: int) -> dict:
    return tree_map(lambda t: t[i], blocks)


# ---------------------------------------------------------------------------
# Sequence forward (prefill)
# ---------------------------------------------------------------------------

def _xlstm_pair_seq(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    state: Optional[dict] = None):
    """One (mLSTM, sLSTM) pair over a sequence, from ``state`` (fresh
    when None). Returns (x, {"m": mLSTM state, "s": sLSTM state})."""
    h, new_m = ssm_lib.mlstm_forward(
        p["m"], cfg, rms_norm(x, p["norm_m"], cfg.norm_eps,
                              cfg.fused_rmsnorm),
        None if state is None else state["m"])
    x = x + h
    h, new_s = ssm_lib.slstm_forward(
        p["s"], cfg, rms_norm(x, p["norm_s"], cfg.norm_eps,
                              cfg.fused_rmsnorm),
        None if state is None else state["s"])
    return x + h, {"m": new_m, "s": new_s}


def _attn_args(cfg: ModelConfig, par: Optional[Parallel],
               seq: bool = True):
    """The config and keywords GQA or MLA runs under: the rank's heads
    under ``par`` (a sequence pass entering them through ``par.enter``
    where their outputs are partial)."""
    if par is None:
        return cfg, {}
    kw = {} if cfg.mla is not None else {"kv_heads": par.kv_heads}
    if seq and par.attn_partial:
        kw["enter"] = par.enter
    return par.attn_cfg, kw


def _attn_sum(a_out: torch.Tensor, par: Optional[Parallel]):
    return par.psum(a_out) if par is not None and par.attn_partial \
        else a_out


def _mlp(cfg: ModelConfig, p: dict, h: torch.Tensor,
         par: Optional[Parallel] = None):
    """The block's SwiGLU or MoE on ``h`` -> (out, aux). Under ``par``
    the partial terms (d_ff columns, expert blocks, the shared experts'
    columns) are summed over the ranks in rank order, once, and a term
    the rank computes whole is added after; ``h`` enters each partial
    term through ``par.enter``."""
    if cfg.moe is None:
        if par is None or not par.mlp_partial:
            return swiglu(h, **p), torch.zeros((), dtype=torch.float32,
                                               device=h.device)
        return par.psum(swiglu(par.enter(h), **p)), torch.zeros(
            (), dtype=torch.float32, device=h.device)
    if par is None:
        return moe_lib.moe_forward(p, cfg, h)
    out, aux = moe_lib.moe_forward(
        p, cfg, h, experts=par.experts, shared=False,
        enter=par.enter if par.mlp_partial else None)
    shared = swiglu(par.enter(h) if par.shared_partial else h,
                    **p["shared"]) if cfg.moe.n_shared_experts else None
    if shared is not None and par.shared_partial == par.mlp_partial:
        out, shared = out + shared, None         # one sum for both
    if par.mlp_partial:
        out = par.psum(out)
    if shared is not None:
        out = out + (par.psum(shared) if par.shared_partial else shared)
    return out, aux


def _block_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
               window: Optional[int], attention: str,
               par: Optional[Parallel] = None):
    """One block (or xLSTM pair) over a full sequence. Returns (x,
    cache_parts, aux)."""
    if cfg.family == "ssm":
        x, state = _xlstm_pair_seq(cfg, p, x)
        return x, state, torch.zeros((), dtype=torch.float32,
                                     device=x.device)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps, cfg.fused_rmsnorm)
    acfg, kw = _attn_args(cfg, par)
    if cfg.mla is not None:
        a_out, kv = attn.mla_forward(p["attn"], acfg, h, positions,
                                     window=window, attention=attention,
                                     **kw)
        cache = {"c": kv[0], "k_rope": kv[1]}
    else:
        a_out, kv = attn.gqa_forward(p["attn"], acfg, h, positions,
                                     window=window, attention=attention,
                                     **kw)
        cache = {"k": kv[0], "v": kv[1]}
    a_out = _attn_sum(a_out, par)
    cache = {"kv": cache}
    if cfg.family == "hybrid":
        # attention and Mamba heads in parallel on the same normed input
        s_out, cache["ssm"] = ssm_lib.mamba_forward(p["ssm"], cfg, h)
        a_out = (a_out + s_out) * 0.5
    x = x + a_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps, cfg.fused_rmsnorm)
    m_out, aux = _mlp(cfg, p["mlp"], h, par)
    return x + m_out, cache, aux


def _par_block_seq(cfg: ModelConfig, par: Parallel, i: int,
                   x: torch.Tensor, positions, window: Optional[int],
                   attention: str):
    """Layer i under ``par``: its parameters are taken (gathered) inside,
    so a checkpoint's recompute gathers them again and nothing of them
    stays saved between the forward and the backward."""
    return _block_seq(cfg, par.layer(i), x, positions, window, attention,
                      par)


def _layers(cfg: ModelConfig, params: dict, tokens, prefix_embeds,
            positions, window: Optional[int], collect_cache: bool,
            remat: bool, attention: str, keep: Optional[Callable],
            par: Optional[Parallel]):
    """The embedding and the layer loop of :func:`forward`: (x, aux,
    caches)."""
    attn.check_route(attention)
    x = embed_inputs(cfg, params, tokens, prefix_embeds, par)
    if attention == "flash":
        attn.check_positions(positions, x.shape[1])
        positions = None
    recording = remat and torch.is_grad_enabled() and (
        x.requires_grad
        or any(t.requires_grad for _, t in tree_paths(params["blocks"])))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = []
    for i in range(n_block_stacks(cfg)):
        if par is None:
            fn, args, kw = _block_seq, (cfg, _layer(params["blocks"], i), x,
                                        positions, window, attention), {}
        else:
            # a full recompute: it repeats every collective of the layer,
            # in the same order on every rank
            fn, args, kw = _par_block_seq, (cfg, par, i, x, positions,
                                            window, attention), {
                "early_stop": False}
        x, cache, a = (checkpoint(fn, *args, use_reentrant=False, **kw)
                       if recording else fn(*args))
        del args                       # a layer's gathered leaves go now
        aux = aux + a
        if collect_cache:
            layers.append(cache if keep is None else keep(i, cache))
    caches = _stack(layers) if collect_cache else None
    return x, aux, caches


def forward(cfg: ModelConfig, params: dict, tokens=None, prefix_embeds=None,
            positions=None, window: Optional[int] = None,
            collect_cache: bool = False, remat: bool = True,
            last_only: bool = False, attention: str = "flash",
            keep: Optional[Callable] = None,
            par: Optional[Parallel] = None):
    """Full-sequence forward. Returns (logits, aux, cache_parts|None);
    cache_parts are stacked over layers, ``{"kv": {"k": (L, B, S, Hkv,
    hd), "v": ...}}`` (GQA) or ``{"kv": {"c": (L, B, S, r), "k_rope": (L,
    B, S, rope)}}`` (MLA), plus ``"ssm"``, Mamba's final state (hybrid);
    xLSTM's are its pairs' final states ``{"m": ..., "s": ...}``. ``aux``
    sums the MoE load-balance term over layers (0 without MoE).

    ``attention="flash"`` (serving's route) takes ``positions`` None or
    ``arange(S)`` only (the kernel's absolute indices) and has no
    backward; ``attention="chunked"`` (the training route) takes any
    ``positions``. MLA layers take the same route, with v's head dim
    their own (DeepSeek-V2-Lite's q/k 192, v 128). ``remat`` checkpoints each
    layer while autograd records (recomputed in the backward, as the
    reference's ``jax.checkpoint`` of its layer scan); when it does not
    record, it changes nothing. ``keep(i, parts)`` maps each layer's
    cache parts as they come (the stack holds what it returns);
    ``par``: a rank's part in a tensor-parallel pass (:class:`Parallel`;
    under ``remat`` each layer's recompute gathers its leaves again)."""
    x, aux, caches = _layers(cfg, params, tokens, prefix_embeds, positions,
                             window, collect_cache, remat, attention, keep,
                             par)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.fused_rmsnorm)
    return lm_logits(cfg, params, x, par), aux, caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                 dev) -> dict:
    """One layer's (or xLSTM pair's) empty cache, unstacked."""
    if cfg.family == "ssm":
        return {"m": ssm_lib.init_mlstm_state(cfg, batch, dtype, dev),
                "s": ssm_lib.init_slstm_state(cfg, batch, dtype, dev)}
    lead = (batch, cache_len)
    if cfg.mla is not None:
        shapes = {"c": lead + (cfg.mla.kv_lora_rank,),
                  "k_rope": lead + (cfg.mla.qk_rope_head_dim,)}
    else:
        shapes = dict.fromkeys(("k", "v"), lead + (cfg.n_kv_heads,
                                                   cfg.resolved_head_dim))
    cache = {"kv": {name: torch.zeros(shape, dtype=dtype, device=dev)
                    for name, shape in shapes.items()}}
    if cfg.family == "hybrid":
        cache["ssm"] = ssm_lib.init_mamba_state(cfg, batch, dtype, dev)
    return cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Empty decode cache; ``cache_len`` is the ring size. Per layer it
    holds K and V (L, B, W, Hkv, hd), or MLA's latent ``c`` (L, B, W,
    kv_lora_rank) and ``k_rope`` (L, B, W, qk_rope_head_dim); a hybrid
    layer adds ``"ssm"``: Mamba's ``h`` (L, B, d_in, N) and ``conv`` (L,
    B, K-1, d_in). xLSTM's pairs hold ``{"m": {"C", "n", "m", "conv"},
    "s": {"h", "c", "n", "m"}}`` stacked (L / slstm_every, B, ...) and no
    ring (``slot_pos`` is kept for the layout's sake)."""
    dev = resolve_device(device)
    block = _block_cache(cfg, batch, cache_len, dtype, dev)
    nb = n_block_stacks(cfg)
    return {"pos": torch.zeros((), dtype=torch.long, device=dev),
            "slot_pos": torch.full((cache_len,), -1, dtype=torch.long,
                                   device=dev),
            "blocks": tree_map(lambda t: t.expand(nb, *t.shape).contiguous(),
                               block)}


def _fit_ring(x: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """One layer's ring leaf over a prompt, (B, S, ...) -> (B, W, ...):
    its last W positions, or zero padded to W. Ring alignment: the next
    write goes to S % W, which must be the oldest entry, so a full ring
    is rolled by S % W."""
    if S < W:
        pad = torch.zeros(x.shape[:1] + (W - S,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=1)
    return torch.roll(x[:, S - W:], S % W, dims=1)


def prefill(cfg: ModelConfig, params: dict, tokens=None, prefix_embeds=None,
            cache_len: Optional[int] = None, window: Optional[int] = None,
            last_only: bool = True, par: Optional[Parallel] = None):
    """Run the prompt, build the decode cache. Returns (logits, cache).
    The attention ring is cut or padded to ``cache_len``, layer by layer;
    recurrent states are the prompt's final ones, untouched. ``par``: a
    rank's part in a tensor-parallel pass (:class:`Parallel`), whose
    ``keep`` cuts each layer's cache to the rank's blocks."""
    S = (tokens.shape[1] if tokens is not None else 0) + \
        (prefix_embeds.shape[1] if prefix_embeds is not None else 0)
    cache_len = cache_len or S

    def keep(i, parts):
        if cfg.family != "ssm":
            parts = dict(parts, kv=tree_map(
                lambda x: _fit_ring(x, S, cache_len), parts["kv"]))
        return parts if par is None else par.keep(i, parts)

    logits, _, blocks = forward(cfg, params, tokens, prefix_embeds,
                                window=window, collect_cache=True,
                                last_only=last_only, keep=keep, par=par)
    dev = logits.device
    pos = torch.tensor(S, dtype=torch.long, device=dev)
    if cfg.family == "ssm":
        return logits, {"pos": pos, "slot_pos": torch.zeros(
            (cache_len,), dtype=torch.long, device=dev), "blocks": blocks}
    held = min(S, cache_len)
    slot_pos = torch.full((cache_len,), -1, dtype=torch.long, device=dev)
    slot_pos[:held] = torch.arange(S - held, S, device=dev)
    if held == cache_len:
        slot_pos = torch.roll(slot_pos, S % cache_len)
    return logits, {"pos": pos, "slot_pos": slot_pos, "blocks": blocks}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _write_state(cache: dict, state: dict) -> None:
    """Copy a recurrent state over its cache leaves, in place: each step
    makes new state tensors, and the caller keeps the cache."""
    for (_, dst), (_, src) in zip(tree_paths(cache), tree_paths(state)):
        dst.copy_(src)


def _block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  pos: torch.Tensor, slot_pos: torch.Tensor, cache: dict,
                  par: Optional[Parallel] = None):
    """One block's (or xLSTM pair's) decode step: writes ``cache`` in
    place and returns the new x."""
    if cfg.family == "ssm":
        x, state = _xlstm_pair_seq(cfg, p, x, cache)
        _write_state(cache, state)
        return x
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps, cfg.fused_rmsnorm)
    acfg, kw = _attn_args(cfg, par, seq=False)
    if cfg.mla is not None:
        # no window, as in the reference's MLA decode
        a_out, _ = attn.mla_decode(p["attn"], acfg, h, pos, cache["kv"],
                                   slot_pos, absorb=cfg.mla_absorb)
    else:
        a_out, _ = attn.gqa_decode(p["attn"], acfg, h, pos, cache["kv"],
                                   slot_pos, **kw)
    a_out = _attn_sum(a_out, par)
    if cfg.family == "hybrid":
        s_out, state = ssm_lib.mamba_decode(p["ssm"], cfg, h, cache["ssm"])
        _write_state(cache["ssm"], state)
        a_out = (a_out + s_out) * 0.5
    x = x + a_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps, cfg.fused_rmsnorm)
    # each batch row (each slot) routes its one token alone
    m_out, _ = _mlp(cfg, p["mlp"], h, par)
    return x + m_out


def _decode_layers(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   pos: torch.Tensor, slot_pos: torch.Tensor,
                   blocks: dict, par: Optional[Parallel] = None
                   ) -> torch.Tensor:
    for i in range(n_block_stacks(cfg)):
        if par is None:
            p, rows = _layer(params["blocks"], i), contextlib.nullcontext(
                _layer(blocks, i))
        else:
            p, rows = par.layer(i), par.cache(i, blocks)
        with rows as c:
            x = _block_decode(cfg, p, x, pos, slot_pos, c, par)
        del p, rows, c                 # a layer's gathered leaves go now
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.fused_rmsnorm)
    return lm_logits(cfg, params, x, par)


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, par: Optional[Parallel] = None):
    """token: (B,) or (B,1) int. Returns (logits (B,1,V), cache): the
    cache's ring, recurrent states and ``slot_pos`` are written in place
    (xLSTM's ``slot_pos`` stays as it is, as in the reference), ``pos``
    is a new tensor one further. ``par``: a rank's part in a
    tensor-parallel pass (:class:`Parallel`)."""
    if token.dim() == 1:
        token = token[:, None]
    x = embed_inputs(cfg, params, token, par=par)
    pos = cache["pos"]
    slot_pos = cache["slot_pos"]
    if cfg.family != "ssm":
        slot_pos[pos % slot_pos.shape[0]] = pos
    logits = _decode_layers(cfg, params, x, pos, slot_pos, cache["blocks"],
                            par)
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
    x = params["embed"][tokens][:, None]                 # (slots, 1, D)
    pos = cache["pos"]
    slot_pos = cache["slot_pos"]
    if cfg.family != "ssm":
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


def _cross_entropy_blocks(cfg: ModelConfig, params: dict, x: torch.Tensor,
                          labels: torch.Tensor, par: Parallel
                          ) -> torch.Tensor:
    """:func:`_cross_entropy` of the head's logits at ``x`` under ``par``,
    the reference's design for vocabulary-sharded logits, which are never
    gathered: with a vocabulary block each rank holds its columns; the
    logsumexp takes the blocks' max (exact) and the rank-order sum of
    each block's exps, and the label's logit is picked from the block
    that holds it (one rank adds a value that is not zero, so its sum is
    exact)."""
    logits = _head(cfg, params, x, par).float()
    if par.vocab is None:
        return _cross_entropy(logits, labels)
    lo, hi = par.vocab
    top = par.pmax(logits.detach().amax(-1))
    lse = top + torch.log(par.psum(
        torch.exp(logits - top[..., None]).sum(-1)))
    mine = (labels >= lo) & (labels < hi)
    picked = torch.gather(logits, -1, torch.where(
        mine, labels - lo, 0)[..., None].long())[..., 0]
    correct = par.psum(torch.where(mine, picked, 0.0))
    return torch.mean(lse - correct)


def _loss_on(cfg: ModelConfig, params: dict, tokens, labels, prefix_embeds,
             par: Optional[Parallel]) -> torch.Tensor:
    """Cross-entropy (+ aux) of every position past the prefix against
    ``labels``, on the chunked route."""
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    if par is None:
        logits, aux, _ = forward(cfg, params, tokens, prefix_embeds,
                                 attention="chunked")
        return _cross_entropy(logits[:, P:], labels) + aux
    x, aux, _ = _layers(cfg, params, tokens, prefix_embeds, None, None,
                        False, True, "chunked", None, par)
    x = rms_norm(x[:, P:], params["final_norm"], cfg.norm_eps,
                 cfg.fused_rmsnorm)
    return _cross_entropy_blocks(cfg, params, x, labels, par) + aux


def lm_loss_labeled(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    labels: torch.Tensor, prefix_embeds=None,
                    par: Optional[Parallel] = None) -> torch.Tensor:
    """Cross-entropy of the logits at every token position against
    ``labels`` (+ the aux term), on the chunked (training) route.
    Processes exactly ``tokens.shape[1]`` (+ prefix) positions. ``par``:
    a rank's part in a tensor-parallel pass (:class:`Parallel`): the
    rank's rows on its blocks, the logits never gathered
    (:func:`_cross_entropy_blocks`)."""
    return _loss_on(cfg, params, tokens, labels, prefix_embeds, par)


def lm_loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds=None, par: Optional[Parallel] = None
            ) -> torch.Tensor:
    """Next-token cross-entropy (+ the aux term) on the chunked (training)
    route. tokens: (B, S_text). ``par`` as in :func:`lm_loss_labeled`."""
    return _loss_on(cfg, params, tokens[:, :-1], tokens[:, 1:],
                    prefix_embeds, par)

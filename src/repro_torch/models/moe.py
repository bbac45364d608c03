"""Mixture-of-Experts with sort-based grouped dispatch.

The port of the JAX package's ``models/moe.py``. Routing is per batch
row, as the reference's ``vmap`` over rows makes it: each row's tokens
are sorted by expert (a stable sort, so within an expert earlier tokens
take the capacity first), ranked within their expert, and the first
``cap`` of each expert fill its (E, cap) buffer; the rest are dropped.
Here the rows are an explicit batch dimension, (B, E, cap, D) dispatch
buffers, and each expert weight takes one batched product over all rows'
buffers (``torch.bmm`` over E), so a decode tick reads every expert
weight once, not once per slot.

The combine is a gather, never a scatter-add: each (token, choice) pair
keeps the buffer slot it went to (or "dropped", a zero row), and a
token's k weighted expert outputs are summed in top-k order. The
reference's ``.at[].add`` sums the same products in XLA's order, so the
two differ only in rounding; on the card the sum repeats bit for bit
(``index_add_`` would sum in the order its atomics land).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_swiglu, swiglu


def init_moe(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """The router (d, E), always float32; the experts' ``w_gate`` and
    ``w_up`` (E, d, f) and ``w_down`` (E, f, d); the shared experts as one
    SwiGLU of width ``n_shared_experts · d_ff_expert``. As in the
    reference, ``dense_init`` takes the fan-in from the leading axis, E
    for the expert weights."""
    m, d = cfg.moe, cfg.d_model
    p = {
        "router": dense_init(generator, (d, m.n_experts), torch.float32),
        "w_gate": dense_init(generator, (m.n_experts, d, m.d_ff_expert),
                             dtype),
        "w_up": dense_init(generator, (m.n_experts, d, m.d_ff_expert),
                           dtype),
        "w_down": dense_init(generator, (m.n_experts, m.d_ff_expert, d),
                             dtype),
    }
    if m.n_shared_experts:
        p["shared"] = init_swiglu(generator, d,
                                  m.n_shared_experts * m.d_ff_expert, dtype)
    return p


def moe_shapes(cfg) -> dict:
    """The shapes of :func:`init_moe`'s tree."""
    m, d = cfg.moe, cfg.d_model
    f, E = m.d_ff_expert, m.n_experts
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    if m.n_shared_experts:
        fs = m.n_shared_experts * f
        shapes["shared"] = {"w_gate": (d, fs), "w_up": (d, fs),
                            "w_down": (fs, d)}
    return shapes


def capacity(cfg, T: int) -> int:
    """Buffer slots per expert for a row of ``T`` tokens, in the
    reference's Python float arithmetic."""
    m = cfg.moe
    return int(T * m.top_k * m.capacity_factor / m.n_experts + 1)


def router_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) -> the router's softmax (B, T, E), in f32."""
    return torch.softmax(x.float() @ p["router"], dim=-1)


def top_k_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The smallest gap, over tokens, between the k-th and the (k+1)-th
    router probability: a rounding difference below it cannot change
    which experts a token picks."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return (top[..., k - 1] - top[..., k]).min()


def moe_forward(p: dict, cfg, x: torch.Tensor, experts=None,
                shared: bool = True, enter=None):
    """x: (B, T, D) -> (y (B, T, D), aux): per-row routing (module doc);
    ``aux`` is the mean over rows of the Switch-style load-balance term,
    in f32.

    ``experts`` ``(lo, hi)``: ``p``'s expert weights are experts lo..hi-1
    of the ``n_experts`` (an expert block of the serving route); every
    token routes over all of them as before, only these experts' buffers
    run, and a pick of another expert adds zero, so ``y`` is this block's
    part of the sum. ``shared=False`` leaves the shared experts out.

    ``enter`` (a rank's part of the experts under autograd, whose ``y``
    is its part of a sum): ``x`` enters the experts' buffers, and the
    routing weights the combine, through it, so that the backward sums
    the ranks' partial gradients; the router reads ``x`` as it is (every
    rank routes alike)."""
    m = cfg.moe
    B, T, D = x.shape
    E, k = m.n_experts, m.top_k
    dev = x.device
    rows = torch.arange(B, device=dev)

    probs = router_probs(p, x)                            # (B, T, E)
    top_w, top_e = torch.topk(probs, k, dim=-1)           # (B, T, k)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)

    # ---- load-balance auxiliary loss (Switch-style), per row ----
    me = probs.mean(1)                                    # (B, E)
    ce = F.one_hot(top_e, E).float().sum(2).mean(1) / k
    aux = m.router_aux_weight * E * (me * ce).sum(-1)

    # ---- sort-based grouped dispatch, local to each row ----
    cap = capacity(cfg, T)
    e_flat = top_e.reshape(B, T * k)
    t_flat = torch.arange(T, device=dev).repeat_interleave(k).expand(B, -1)
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    e_s = torch.gather(e_flat, 1, order)
    t_s = torch.gather(t_flat, 1, order)
    # rank of each entry within its expert group
    same = F.one_hot(e_s, E)                              # (B, T*k, E)
    rank = (torch.cumsum(same, dim=1) * same).sum(-1) - 1
    keep = rank < cap
    slot_s = torch.where(keep, e_s * cap + rank, E * cap)
    # token of each (expert, cap) slot; unfilled slots read the zero pad
    # row T, and dropped entries all land in the trash slot E·cap
    buf_tok = torch.full((B, E * cap + 1), T, dtype=torch.long, device=dev
                         ).scatter_(1, slot_s, t_s)[:, :-1]
    # each (token, choice) pair's slot, back in token order
    slot = torch.empty_like(slot_s).scatter_(1, order, slot_s
                                             ).reshape(B, T, k)

    if experts is not None:
        # the block's slots; every other slot reads the zero row
        lo, hi = experts
        mine = (slot >= lo * cap) & (slot < hi * cap)
        slot = torch.where(mine, slot - lo * cap, (hi - lo) * cap)
        buf_tok, E = buf_tok[:, lo * cap:hi * cap], hi - lo

    if enter is not None:
        x_in, top_w = enter(x), enter(top_w)
    else:
        x_in = x
    xpad = torch.cat([x_in, x.new_zeros((B, 1, D))], dim=1)
    xe = xpad[rows[:, None], buf_tok]                     # (B, E·cap, D)
    xe = xe.reshape(B, E, cap, D).transpose(0, 1).reshape(E, B * cap, D)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                        # (E, B·cap, D)
    ye = ye.reshape(E, B, cap, D).transpose(0, 1).reshape(B, E * cap, D)
    ye = torch.cat([ye, ye.new_zeros((B, 1, D))], dim=1)  # dropped: zero

    # ---- combine: gather each token's k outputs, sum in top-k order ----
    picked = ye[rows[:, None, None], slot]                # (B, T, k, D)
    w = top_w.to(ye.dtype)
    y = picked[:, :, 0] * w[:, :, 0, None]
    for j in range(1, k):
        y = y + picked[:, :, j] * w[:, :, j, None]

    if m.n_shared_experts and shared:
        y = y + swiglu(x, **p["shared"])
    return y, aux.mean()

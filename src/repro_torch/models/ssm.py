"""Recurrent blocks: the Mamba-style selective SSM, mLSTM and sLSTM.

The port of the JAX package's ``models/ssm.py``. Each block has a
sequence forward (training and prefill) and a single-step decode, which
is the sequence forward over one token from a carried state: O(1) state
per layer, whatever the context length.

The reference runs each recurrence as a ``lax.scan``; here it is a Python
loop over time (:func:`time_scan`) that holds only the recurrence. Every
projection, gate and dt over the whole sequence is computed before the
loop, as in the reference, and so are Mamba's exp(dt·A) and dt·B·x, which
are elementwise and do not depend on the carry: the same values.

Constants are the reference's: Mamba's ``A_log`` = log(1..N) per
channel, correctly rounded, and ``D`` = 1 (float32 whatever the dtype),
``dt_bias`` = log(expm1(exp(u))) with u uniform on [log 1e-3, log 1e-1];
mLSTM's gate bias [0]·H ++ [3]·H; sLSTM's recurrent scale d^-½ · 0.5;
and so are the initial states and the stabilisers, bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import causal_conv1d, dense_init


def _scan(step: Callable, carry: tuple, xs: Sequence[torch.Tensor]):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def _scan_flat(step: Callable, n_carry: int, *tensors):
    carry, ys = _scan(step, tuple(tensors[:n_carry]), tensors[n_carry:])
    return (*carry, ys)


def time_scan(step: Callable, carry: Tuple[torch.Tensor, ...],
              xs: Sequence[torch.Tensor], chunk: int = 0):
    """A loop over time: ``step(carry, x_t) -> (carry, y_t)`` for each t,
    where ``carry`` is a tuple of tensors and ``xs`` are time-major (S,
    ...) tensors. Returns ``(carry, ys)`` with ys stacked (S, ...).

    With ``chunk > 0`` and S a multiple of ``chunk`` greater than it, each
    chunk of ``chunk`` steps runs under ``torch.utils.checkpoint`` while
    autograd records: the backward keeps the carry only at chunk
    boundaries and recomputes within a chunk, the counterpart of the
    reference's ``jax.checkpoint``-ed inner scans. Otherwise, and when
    autograd does not record, it is the plain loop; the values are the
    same either way.
    """
    S = xs[0].shape[0]
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*carry, *xs))
    if chunk <= 0 or S % chunk or S <= chunk or not recording:
        return _scan(step, carry, xs)
    n = len(carry)
    ys = []
    for lo in range(0, S, chunk):
        out = checkpoint(_scan_flat, step, n, *carry,
                         *(x[lo:lo + chunk] for x in xs),
                         use_reentrant=False)
        carry, y = tuple(out[:n]), out[n]
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (inside the hybrid blocks)
# ---------------------------------------------------------------------------

def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def mamba_shapes(cfg) -> dict:
    """The shapes of :func:`init_mamba`'s tree."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    return {"w_in": (d, 2 * d_in), "conv_w": (s.conv_dim, d_in),
            "w_xdb": (d_in, _dt_rank(cfg) + 2 * s.state_dim),
            "w_dt": (_dt_rank(cfg), d_in), "dt_bias": (d_in,),
            "A_log": (d_in, s.state_dim), "D": (d_in,), "w_out": (d_in, d)}


def init_mamba(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    shapes = mamba_shapes(cfg)
    d_in, N = shapes["A_log"]
    dev = generator.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = lo + (hi - lo) * torch.rand((d_in,), generator=generator,
                                    device=dev)
    return {
        "w_in": dense_init(generator, shapes["w_in"], dtype),
        "conv_w": dense_init(generator, shapes["conv_w"], dtype, scale=0.5),
        "w_xdb": dense_init(generator, shapes["w_xdb"], dtype),
        "w_dt": dense_init(generator, shapes["w_dt"], dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        # log(1..N) rounded once from float64: the same bits on every
        # device (XLA's f32 log on the CPU is one ulp above it at 7)
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float64,
                                        device=dev)).float().repeat(d_in, 1),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "w_out": dense_init(generator, shapes["w_out"], dtype),
    }


def _mamba_inner(p: dict, cfg, xz: torch.Tensor,
                 conv_state: Optional[torch.Tensor]):
    """xz: (B, S, 2·d_in) pre-projected. Returns the gatable x, z, dt, B,
    C, A and the new conv state."""
    s = cfg.ssm
    x, z = torch.chunk(xz, 2, dim=-1)
    x, new_conv = causal_conv1d(x, p["conv_w"], conv_state)
    x = F.silu(x)
    xdb = x @ p["w_xdb"]
    dtr = _dt_rank(cfg)
    dt = F.softplus(xdb[..., :dtr] @ p["w_dt"] + p["dt_bias"]).float()
    Bm = xdb[..., dtr:dtr + s.state_dim].float()              # (B, S, N)
    Cm = xdb[..., dtr + s.state_dim:].float()                 # (B, S, N)
    A = -torch.exp(p["A_log"])                                # (d_in, N)
    return x, z, dt, Bm, Cm, A, new_conv


def _mamba_step(carry, inp):
    (h,), (dA_t, dBx_t, C_t) = carry, inp
    h = dA_t * h + dBx_t                                      # (B, d_in, N)
    return (h,), torch.einsum("bdn,bn->bd", h, C_t)


def mamba_forward(p: dict, cfg, x: torch.Tensor,
                  state: Optional[dict] = None):
    """x: (B, S, D) -> (y, {"h": (B, d_in, N) f32, "conv": (B, K-1,
    d_in)})."""
    B, S, D = x.shape
    d_in = cfg.ssm.expand * D
    xz = x @ p["w_in"]
    conv_state = None if state is None else state["conv"]
    h0 = (torch.zeros((B, d_in, cfg.ssm.state_dim), dtype=torch.float32,
                      device=x.device)
          if state is None else state["h"])
    xc, z, dt, Bm, Cm, A, new_conv = _mamba_inner(p, cfg, xz, conv_state)
    xf = xc.float()
    dA = torch.exp(dt[..., None] * A)                         # (B,S,d_in,N)
    dBx = dt[..., None] * Bm[:, :, None, :] * xf[..., None]
    (h,), ys = time_scan(_mamba_step, (h0,),
                         tuple(a.transpose(0, 1) for a in (dA, dBx, Cm)),
                         chunk=cfg.recurrent_chunk)
    y = ys.transpose(0, 1) + xf * p["D"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return y, {"h": h, "conv": new_conv}


def mamba_decode(p: dict, cfg, x: torch.Tensor, state: dict):
    """x: (B, 1, D); state: {"h": (B, d_in, N), "conv": (B, K-1, d_in)}."""
    return mamba_forward(p, cfg, x, state)


def init_mamba_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"h": torch.zeros((batch, d_in, s.state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_dim - 1, d_in), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory), xLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg) -> Tuple[int, int]:
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
    return d_in, d_in // cfg.n_heads


def mlstm_shapes(cfg) -> dict:
    """The shapes of :func:`init_mlstm`'s tree."""
    d = cfg.d_model
    d_in, _ = _mlstm_dims(cfg)
    return {"w_up": (d, 2 * d_in), "conv_w": (cfg.xlstm.conv_dim, d_in),
            "wq": (d_in, d_in), "wk": (d_in, d_in), "wv": (d_in, d_in),
            "w_if": (d_in, 2 * cfg.n_heads), "b_if": (2 * cfg.n_heads,),
            "w_o": (d_in, d_in), "w_down": (d_in, d)}


def init_mlstm(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    p = {name: dense_init(generator, shape, dtype,
                          scale=0.5 if name == "conv_w" else None)
         for name, shape in mlstm_shapes(cfg).items() if name != "b_if"}
    H = cfg.n_heads
    p["b_if"] = torch.cat([torch.zeros((H,)), 3.0 * torch.ones((H,))]).to(
        dtype=dtype, device=generator.device)
    return p


def _mlstm_step(carry, inp):
    C, n, m = carry
    q_t, k_t, v_t, li, lf = inp
    q_t, k_t, v_t = q_t.float(), k_t.float(), v_t.float()
    lfm = lf + m
    m_new = torch.maximum(lfm, li)                            # (B, H)
    f_ = torch.exp(lfm - m_new)[..., None, None]
    i_ = torch.exp(li - m_new)[..., None, None]
    C = f_ * C + i_ * (v_t[..., :, None] * k_t[..., None, :])
    n = f_[..., 0] * n + i_[..., 0] * k_t
    num = torch.einsum("bhvk,bhk->bhv", C, q_t)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), num / den


def mlstm_forward(p: dict, cfg, x: torch.Tensor,
                  state: Optional[dict] = None):
    """x: (B, S, D) -> (y, state); the matrix memory per head is C (B, H,
    hd, hd), with the normaliser n (B, H, hd) and the stabiliser m (B,
    H)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    d_in = p["wq"].shape[0]
    hd = d_in // H
    u, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    conv_state = None if state is None else state["conv"]
    uc, new_conv = causal_conv1d(u, p["conv_w"], conv_state)
    uc = F.silu(uc)
    q = (uc @ p["wq"]).reshape(B, S, H, hd)
    k = (uc @ p["wk"]).reshape(B, S, H, hd) * hd ** -0.5
    v = (uc @ p["wv"]).reshape(B, S, H, hd)
    gates = (uc @ p["w_if"] + p["b_if"]).float()              # (B, S, 2H)
    log_i, log_f = gates[..., :H], F.logsigmoid(gates[..., H:])
    if state is None:
        fresh = init_mlstm_state(cfg, B, x.dtype, x.device)
        C0, n0, m0 = fresh["C"], fresh["n"], fresh["m"]
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    (C, n, m), hs = time_scan(
        _mlstm_step, (C0, n0, m0),
        tuple(a.transpose(0, 1) for a in (q, k, v, log_i, log_f)),
        chunk=cfg.recurrent_chunk)
    h = hs.transpose(0, 1).reshape(B, S, d_in).to(x.dtype)
    h = (h @ p["w_o"]) * F.silu(z)
    return h @ p["w_down"], {"C": C, "n": n, "m": m, "conv": new_conv}


def init_mlstm_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    d_in, hd = _mlstm_dims(cfg)
    H = cfg.n_heads
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, H), -1e30, dtype=torch.float32,
                            device=device),
            "conv": torch.zeros((batch, cfg.xlstm.conv_dim - 1, d_in),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory), xLSTM
# ---------------------------------------------------------------------------

def slstm_shapes(cfg) -> dict:
    """The shapes of :func:`init_slstm`'s tree."""
    d = cfg.d_model
    return {"w_x": (d, 4 * d), "r_h": (d, 4 * d), "b": (4 * d,),
            "w_out": (d, d)}


def init_slstm(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d = cfg.d_model
    return {
        "w_x": dense_init(generator, (d, 4 * d), dtype),
        "r_h": dense_init(generator, (d, 4 * d), dtype,
                          scale=d ** -0.5 * 0.5),
        "b": torch.zeros((4 * d,), dtype=dtype, device=generator.device),
        "w_out": dense_init(generator, (d, d), dtype),
    }


def slstm_forward(p: dict, cfg, x: torch.Tensor,
                  state: Optional[dict] = None):
    """x: (B, S, D) -> (y, state): exponential gating with the stabiliser
    m, the normaliser n clamped at 1."""
    B, S, D = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    xw = (x @ p["w_x"] + p["b"]).float()

    def step(carry, inp):
        h, c, n, m = carry
        pre = inp[0] + (h.to(x.dtype) @ p["r_h"]).float()
        zi, zf, zz, zo = torch.chunk(pre, 4, dim=-1)
        log_f = F.logsigmoid(zf)
        lfm = log_f + m
        m_new = torch.maximum(lfm, zi)
        i_ = torch.exp(zi - m_new)
        f_ = torch.exp(lfm - m_new)
        c = f_ * c + i_ * torch.tanh(zz)
        n = f_ * n + i_
        h = torch.sigmoid(zo) * c / torch.clamp_min(n, 1.0)
        return (h, c, n, m_new), h

    (h, c, n, m), hs = time_scan(
        step, (state["h"], state["c"], state["n"], state["m"]),
        (xw.transpose(0, 1),), chunk=cfg.recurrent_chunk)
    y = hs.transpose(0, 1).to(x.dtype) @ p["w_out"]
    return y, {"h": h, "c": c, "n": n, "m": m}


def init_slstm_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """h, c and m zero, n one, all float32 (``dtype`` is unused: the
    reference's sLSTM state has no model-dtype leaf)."""
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": torch.ones_like(z), "m": z.clone()}

"""Causal online-softmax (flash) attention with GQA and an optional window.

``flash_attention_kernel`` maps q (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd),
float32, in any strides with hd contiguous, to (B, Sq, H, hd), or, with
``n_q_heads`` given, the reference's folded q (B·H, Sq, hd) and k, v
(B·Hkv, Sk, hd) to (B·H, Sq, hd): query head ``h`` attends to KV head
``h // G`` (G = H / Hkv) over keys ``k_pos <= q_pos`` (absolute indices
``0..Sq-1`` and ``0..Sk-1``) with ``q_pos − k_pos < window`` when a window
is given, scale ``hd**-0.5``. On a CUDA tensor it launches
``flash_attention_kernel`` of ``kernels/csrc/attention.cu`` (the
counterpart of the JAX package's
``kernels/flash_attention/flash_attention.py::flash_attention_pallas``)
on the tensors' own strides, in either layout, with no copy; on a CPU
tensor it runs :func:`flash_attention_plain`, the same algorithm in
PyTorch. The kernel is compiled for head dims 32, 64 and 128; any other
head dim up to 128 runs on the next of them, with q, k and v zero-padded
in their last axis (zero columns add nothing to q·k, and v's give only
output columns that are sliced away) and the true scale.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import register_kernel, stream_of

NEG_INF = -1e30
#: query positions of a tile and keys of a KV tile, in the kernel
#: (``FA_ROWS``, ``FA_BK``) and in the plain version
BLOCK_Q = BLOCK_K = 64
#: head dims the CUDA kernel is compiled for
KERNEL_HEAD_DIMS = (32, 64, 128)


def kernel_head_dim(hd: int) -> int:
    """The compiled head dim that runs head dim ``hd``: the smallest of
    :data:`KERNEL_HEAD_DIMS` that holds it."""
    for h in KERNEL_HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(
        f"flash_attention: the CUDA kernel takes head_dim up to "
        f"{KERNEL_HEAD_DIMS[-1]}, got {hd}: its shared memory grows by "
        f"1,280 bytes per unit of head dim, past the H100's 227 KB a block "
        f"near 192, so larger head dims need their own tiling (ROADMAP "
        f"Queue 1 item 7, MLA)")


def kernel_shared_bytes(hd: int) -> int:
    """Dynamic shared memory of one block of the CUDA kernel at head dim
    ``hd``, as the kernel library reports it (builds the library)."""
    return _build.library().repro_flash_attention_shared_bytes(hd)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> contiguous (B·H, S, hd), as the reference's
    ``_fold``; no copy when ``x`` is an unfolded contiguous tensor."""
    B, S, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def _unfold(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B·H, S, hd) -> a (B, S, H, hd) view."""
    BH, S, hd = x.shape
    return x.reshape(B, BH // B, S, hd).transpose(1, 2)


def _heads(q: torch.Tensor, k: torch.Tensor, n_q_heads: int):
    """(B, H, Hkv, G) of folded q (B·H, Sq, hd) and k (B·Hkv, Sk, hd)."""
    bh, bhkv, H = q.shape[0], k.shape[0], int(n_q_heads)
    if H < 1 or bh % H:
        raise ValueError(f"flash_attention: {bh} query rows are not a "
                         f"multiple of n_q_heads={H}")
    B = bh // H
    if bhkv % B or H % (bhkv // B):
        raise ValueError(f"flash_attention: {bhkv} KV rows do not divide "
                         f"into B={B} batches of a divisor of H={H}")
    Hkv = bhkv // B
    return B, H, Hkv, H // Hkv


def _check_window(window: Optional[int]) -> int:
    """The window as the kernel takes it: 0 for none."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    return int(window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_q_heads: int, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's algorithm in PyTorch on folded tensors: q in tiles of
    :data:`BLOCK_Q` positions, each walking the KV tiles of
    :data:`BLOCK_K` keys that the causal mask and the window reach, with
    the running max, denominator and accumulator of the online softmax.
    Memory stays at one tile's scores per step. ``scale`` defaults to
    ``hd**-0.5``."""
    B, H, Hkv, G = _heads(q, k, n_q_heads)
    win = _check_window(window)
    _, Sq, hd = q.shape
    Sk = k.shape[1]
    dev = q.device
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    kg = k.float().reshape(B, Hkv, Sk, hd)
    vg = v.float().reshape(B, Hkv, Sk, hd)
    if scale is None:
        scale = hd ** -0.5
    out = torch.zeros_like(qg)
    for q0 in range(0, Sq, BLOCK_Q):
        qt = qg[:, :, :, q0:q0 + BLOCK_Q]
        bq = qt.shape[3]
        q_pos = torch.arange(q0, q0 + bq, device=dev)[:, None]
        m = torch.full((B, Hkv, G, bq, 1), NEG_INF, device=dev)
        den = torch.zeros((B, Hkv, G, bq, 1), device=dev)
        acc = torch.zeros((B, Hkv, G, bq, hd), device=dev)
        k_hi = min(q0 + bq - 1, Sk - 1)
        k_lo = max(0, q0 - win + 1) if win else 0
        for k0 in range(k_lo // BLOCK_K * BLOCK_K, k_hi + 1, BLOCK_K):
            kt = kg[:, :, k0:k0 + BLOCK_K]
            vt = vg[:, :, k0:k0 + BLOCK_K]
            bk = kt.shape[2]
            k_pos = torch.arange(k0, k0 + bk, device=dev)[None, :]
            mask = k_pos <= q_pos
            if win:
                mask &= (q_pos - k_pos) < win
            s = (qt.reshape(B, Hkv, G * bq, hd) @ kt.transpose(-1, -2)
                 ).reshape(B, Hkv, G, bq, bk) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            den = alpha * den + p.sum(-1, keepdim=True)
            acc = alpha * acc + (p.reshape(B, Hkv, G * bq, bk) @ vt
                                 ).reshape(B, Hkv, G, bq, hd)
            m = m_new
        out[:, :, :, q0:q0 + bq] = acc / torch.clamp_min(den, 1e-30)
    return out.reshape(B * H, Sq, hd).to(q.dtype)


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           n_q_heads: Optional[int] = None,
           window: Optional[int] = None) -> torch.Tensor:
    """The plain route of :data:`flash_attention_kernel`: folded tensors
    go to :func:`flash_attention_plain` as they are, (B, S, H, hd) ones
    are folded first and the result unfolded into a contiguous tensor."""
    if n_q_heads is not None:
        return flash_attention_plain(q, k, v, n_q_heads, window)
    B, _, H, _ = q.shape
    return _unfold(flash_attention_plain(_fold(q), _fold(k), _fold(v), H,
                                         window), B).contiguous()


def _refuse(t: torch.Tensor, name: str, ndim: int):
    """Why the kernel's copies cannot take ``t``: they read float32 rows
    with hd contiguous, every row 16-byte aligned."""
    if t.dtype != torch.float32:
        raise TypeError(f"flash_attention: {name} must be float32, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"flash_attention: {name} must be a {ndim}-D "
                         f"tensor, got shape {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must have a contiguous "
                         f"head dim, got strides {t.stride()}")
    raise ValueError(f"flash_attention: {name}'s rows must start 16-byte "
                     f"aligned, got strides {t.stride()} at "
                     f"{t.data_ptr() % 16} bytes past a 16-byte boundary")


def _rows(t: torch.Tensor, name: str, ndim: int) -> tuple:
    """(data pointer, strides) of ``t`` when the kernel's copies take it."""
    st, ptr = t.stride(), t.data_ptr()
    if (t.dtype is torch.float32 and len(st) == ndim and st[-1] == 1
            and not (st[0] | st[1] | st[ndim - 2]) & 3 and not ptr & 15):
        return ptr, st
    _refuse(t, name, ndim)


_FLASH = _build.CFunction("repro_flash_attention_f32", "flash_attention")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_q_heads: Optional[int] = None,
                window: Optional[int] = None) -> torch.Tensor:
    hd = q.shape[-1]
    if k.shape[-1] != hd:
        raise ValueError(f"flash_attention: the CUDA kernel takes one "
                         f"head_dim for q and k alike, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    hd_k = kernel_head_dim(hd)
    if hd_k == hd:
        return _flash_launch(q, k, v, n_q_heads, window, hd ** -0.5)
    pad = (0, hd_k - hd)
    out = _flash_launch(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad),
                        n_q_heads, window, hd ** -0.5)
    return out[..., :hd].contiguous()


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_q_heads: Optional[int], window: Optional[int],
                  scale: float) -> torch.Tensor:
    """One launch at a compiled head dim."""
    folded = n_q_heads is not None
    nd = 3 if folded else 4
    (qp, qs), (kp, ks), (vp, vs) = (_rows(q, "q", nd), _rows(k, "k", nd),
                                    _rows(v, "v", nd))
    if vs != ks or k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} {ks} and v "
                         f"{tuple(v.shape)} {vs} differ in shape or strides")
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("flash_attention: q, k and v must share a device")
    if folded:
        B, H, Hkv, _ = _heads(q, k, n_q_heads)
        _, sq, hd = q.shape
        sk = k.shape[1]
        # (b, s, h) of a folded row lies at (b·H + h)·s0 + s·s1
        q_st = (H * qs[0], qs[1], qs[0])
        kv_st = (Hkv * ks[0], ks[1], ks[0])
        out = torch.empty((B * H, sq, hd), dtype=q.dtype, device=q.device)
        o_st = (H * sq * hd, hd, sq * hd)
    else:
        B, sq, H, hd = q.shape
        sk, Hkv = k.shape[1], k.shape[2]
        if k.shape[0] != B or H % Hkv:
            raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                             f"{tuple(k.shape)} differ in batch, or the "
                             f"heads are no multiple of the KV heads")
        q_st, kv_st = qs[:3], ks[:3]
        out = torch.empty((B, sq, H, hd), dtype=q.dtype, device=q.device)
        o_st = (sq * H * hd, H * hd, hd)
    if sq < 1 or sk < 1 or -(-sq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: needs Sq, Sk >= 1 and at most "
                         f"65535 query tiles; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    _FLASH(qp, kp, vp, out.data_ptr(), *q_st, *kv_st, *o_st, B, sq, sk, hd,
           H, Hkv, _check_window(window), scale, stream_of(q))
    return out


#: q (B·H, Sq, hd), k and v (B·Hkv, Sk, hd) with ``n_q_heads`` given, or
#: the model's q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd) without it; the
#: result in the same layout as q, contiguous
flash_attention_kernel = register_kernel(
    "flash_attention", plain=_plain, launch=_flash_cuda)

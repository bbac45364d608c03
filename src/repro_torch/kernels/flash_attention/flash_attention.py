"""Causal online-softmax (flash) attention with GQA and an optional window.

``flash_attention_kernel`` maps q (B·H, Sq, hd) and k, v (B·Hkv, Sk, hd),
float32, to (B·H, Sq, hd): query head ``bh`` attends to KV head
``(bh // H)·Hkv + (bh % H) // G`` over keys ``k_pos <= q_pos`` (absolute
indices ``0..Sq-1`` and ``0..Sk-1``) with ``q_pos − k_pos < window`` when a
window is given, scale ``hd**-0.5``. On a CUDA tensor it launches
``flash_attention_kernel`` of ``kernels/csrc/attention.cu`` (the
counterpart of the JAX package's
``kernels/flash_attention/flash_attention.py::flash_attention_pallas``);
on a CPU tensor it runs :func:`flash_attention_plain`, the same algorithm
in PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import register_kernel, stream_of

NEG_INF = -1e30
#: query rows per tile and keys per KV tile, in the kernel and here
BLOCK_Q = BLOCK_K = 64
#: head dims the CUDA kernel is compiled for
KERNEL_HEAD_DIMS = (32, 64, 128)


def kernel_shared_bytes(hd: int) -> int:
    """Dynamic shared memory of one block of the CUDA kernel at head dim
    ``hd``, as the kernel library reports it (builds the library)."""
    return _build.library().repro_flash_attention_shared_bytes(hd)


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
                          n_q_heads: int,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's algorithm in PyTorch: q in tiles of 64 rows, each
    walking the KV tiles of 64 keys that the causal mask and the window
    reach, with the running max, denominator and accumulator of the
    online softmax. Memory stays at one tile's scores per step."""
    B, H, Hkv, G = _heads(q, k, n_q_heads)
    win = _check_window(window)
    _, Sq, hd = q.shape
    Sk = k.shape[1]
    dev = q.device
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    kg = k.float().reshape(B, Hkv, Sk, hd)
    vg = v.float().reshape(B, Hkv, Sk, hd)
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


_FLASH = _build.CFunction("repro_flash_attention_f32", "flash_attention")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_q_heads: int, window: Optional[int] = None) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"3-D tensor, got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must share a "
                             "device")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape[2] != hd:
        raise ValueError("flash_attention: q and k head dims differ")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"in {KERNEL_HEAD_DIMS}, got {hd}")
    if sq < 1 or sk < 1 or bh > 65535:
        raise ValueError(f"flash_attention: needs Sq, Sk >= 1 and B·H <= "
                         f"65535; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    _, H, _, G = _heads(q, k, n_q_heads)
    win = _check_window(window)
    out = torch.empty_like(q)
    _FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
           sk, hd, H, G, win, hd ** -0.5, stream_of(q))
    return out


flash_attention_kernel = register_kernel(
    "flash_attention", plain=flash_attention_plain, launch=_flash_cuda)

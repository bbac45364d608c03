"""Causal online-softmax (flash) attention with GQA and an optional window.

``flash_attention_kernel`` maps q (B, Sq, H, hd), k (B, Sk, Hkv, hd) and
v (B, Sk, Hkv, hd_v), float32, in any strides with the head dim
contiguous, to (B, Sq, H, hd_v), or, with ``n_q_heads`` given, the
reference's folded q (B·H, Sq, hd), k (B·Hkv, Sk, hd) and v (B·Hkv, Sk,
hd_v) to (B·H, Sq, hd_v): query head ``h`` attends to KV head ``h // G``
(G = H / Hkv) over keys ``k_pos <= q_pos`` (absolute indices ``0..Sq-1``
and ``0..Sk-1``) with ``q_pos − k_pos < window`` when a window is given,
scale ``hd**-0.5``. k and v agree in every axis but the last: v's head
dim may be narrower (MLA's 192/128 for DeepSeek-V2-Lite, 96/64 for
MiniCPM3-4B). On a CUDA tensor it launches ``flash_attention_kernel`` of
``kernels/csrc/attention.cu`` (the counterpart of the JAX package's
``kernels/flash_attention/flash_attention.py::flash_attention_pallas``)
on the tensors' own strides, in either layout, with no copy; on a CPU
tensor it runs :func:`flash_attention_plain`, the same algorithm in
PyTorch.

The kernel is compiled for the (q/k, v) head dims of
:data:`KERNEL_INSTANCES`: 32, 64 and 128 with 64-key KV tiles, and 192
and 256 with 32-key tiles (what fits an H100 block's shared memory). Any
other pair up to 256 runs on the smallest instance that holds it, with
q and k zero-padded to its q/k head dim and v to its v head dim (zero
columns add nothing to q·k, and v's give only output columns that are
sliced away) and the true scale. Head dims above 256 raise (ROADMAP,
Queue 2).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import register_kernel, stream_of

NEG_INF = -1e30
#: query positions of a tile, in the kernel (``FA_ROWS``) and in the plain
#: version
BLOCK_Q = 64
#: keys of a KV tile (the kernel's ``fa_block_k``): 64 up to head dim 128,
#: 32 above it, where a two-stage ring of 64-key tiles would pass the
#: H100's 232,448 bytes of shared memory a block
BLOCK_K, BLOCK_K_WIDE = 64, 32
#: the (q/k head dim, v head dim) pairs the CUDA kernel is compiled for
#: (``FA_INSTANCES`` in ``csrc/attention.cu``)
KERNEL_INSTANCES = ((32, 32), (64, 64), (128, 64), (128, 128), (192, 128),
                    (192, 192), (256, 256))
#: the q/k head dims among them
KERNEL_HEAD_DIMS = tuple(sorted({hd for hd, _ in KERNEL_INSTANCES}))


def kernel_head_dim(hd: int) -> int:
    """The compiled q/k head dim that runs head dim ``hd``: the smallest
    of :data:`KERNEL_HEAD_DIMS` that holds it."""
    for h in KERNEL_HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(
        f"flash_attention: the CUDA kernel takes head_dim up to "
        f"{KERNEL_HEAD_DIMS[-1]}, got {hd}: at 32-key tiles Q, the K/V ring "
        f"and P pass the H100's 232,448 bytes of shared memory a block "
        f"beyond 256, so larger head dims need a tiling of their own "
        f"(ROADMAP, Queue 2: flash head dims above 256)")


def kernel_instance(hd: int, hd_v: int) -> tuple:
    """The compiled (q/k, v) head dims that run q/k head dim ``hd`` with v
    head dim ``hd_v``: the q/k head dim that holds both, and the smallest
    of its v head dims that holds ``hd_v``."""
    top = kernel_head_dim(max(hd, hd_v))
    return top, min(v for h, v in KERNEL_INSTANCES
                    if h == top and v >= hd_v)


def block_k(hd: int, hd_v: int) -> int:
    """Keys per KV tile of the instance that runs (``hd``, ``hd_v``); the
    plain version walks the same tiles at any head dim."""
    return BLOCK_K if max(hd, hd_v) <= 128 else BLOCK_K_WIDE


def kernel_shared_bytes(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of one block of the CUDA kernel's (``hd``,
    ``hd_v``) instance, as the kernel library reports it (builds the
    library)."""
    return _build.library().repro_flash_attention_shared_bytes(hd, hd_v)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> contiguous (B·H, S, hd), as the reference's
    ``_fold``; no copy when ``x`` is an unfolded contiguous tensor."""
    B, S, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def _unfold(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B·H, S, hd) -> a (B, S, H, hd) view."""
    BH, S, hd = x.shape
    return x.reshape(B, BH // B, S, hd).transpose(1, 2)


def _check_kv(k: torch.Tensor, v: torch.Tensor) -> None:
    """k and v agree in every axis but the last (v's head dim may be its
    own)."""
    if k.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must agree in every axis but "
                         f"the last")


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
    """The kernel's algorithm in PyTorch on folded tensors: q (B·H, Sq,
    hd), k (B·Hkv, Sk, hd), v (B·Hkv, Sk, hd_v) -> (B·H, Sq, hd_v), q in
    tiles of :data:`BLOCK_Q` positions, each walking the KV tiles of
    :func:`block_k` keys (the kernel's tile at these head dims) that the
    causal mask and the window reach, with the running max, denominator
    and accumulator of the online softmax. Memory stays at one tile's
    scores per step. ``scale`` defaults to ``hd**-0.5``."""
    B, H, Hkv, G = _heads(q, k, n_q_heads)
    _check_kv(k, v)
    win = _check_window(window)
    _, Sq, hd = q.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    bk = block_k(hd, hd_v)
    dev = q.device
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    kg = k.float().reshape(B, Hkv, Sk, hd)
    vg = v.float().reshape(B, Hkv, Sk, hd_v)
    if scale is None:
        scale = hd ** -0.5
    out = torch.zeros((B, Hkv, G, Sq, hd_v), device=dev)
    for q0 in range(0, Sq, BLOCK_Q):
        qt = qg[:, :, :, q0:q0 + BLOCK_Q]
        bq = qt.shape[3]
        q_pos = torch.arange(q0, q0 + bq, device=dev)[:, None]
        m = torch.full((B, Hkv, G, bq, 1), NEG_INF, device=dev)
        den = torch.zeros((B, Hkv, G, bq, 1), device=dev)
        acc = torch.zeros((B, Hkv, G, bq, hd_v), device=dev)
        k_hi = min(q0 + bq - 1, Sk - 1)
        k_lo = max(0, q0 - win + 1) if win else 0
        for k0 in range(k_lo // bk * bk, k_hi + 1, bk):
            kt = kg[:, :, k0:k0 + bk]
            vt = vg[:, :, k0:k0 + bk]
            nk = kt.shape[2]
            k_pos = torch.arange(k0, k0 + nk, device=dev)[None, :]
            mask = k_pos <= q_pos
            if win:
                mask &= (q_pos - k_pos) < win
            s = (qt.reshape(B, Hkv, G * bq, hd) @ kt.transpose(-1, -2)
                 ).reshape(B, Hkv, G, bq, nk) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            den = alpha * den + p.sum(-1, keepdim=True)
            acc = alpha * acc + (p.reshape(B, Hkv, G * bq, nk) @ vt
                                 ).reshape(B, Hkv, G, bq, hd_v)
            m = m_new
        out[:, :, :, q0:q0 + bq] = acc / torch.clamp_min(den, 1e-30)
    return out.reshape(B * H, Sq, hd_v).to(q.dtype)


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
    hd, hd_v = q.shape[-1], v.shape[-1]
    if k.shape[-1] != hd:
        raise ValueError(f"flash_attention: the CUDA kernel takes one "
                         f"head_dim for q and k alike, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    _check_kv(k, v)
    hd_k, hd_kv = kernel_instance(hd, hd_v)
    if hd_k != hd:
        q, k = (F.pad(x, (0, hd_k - hd)) for x in (q, k))
    if hd_kv != hd_v:
        v = F.pad(v, (0, hd_kv - hd_v))
    out = _flash_launch(q, k, v, n_q_heads, window, hd ** -0.5)
    return out if hd_kv == hd_v else out[..., :hd_v].contiguous()


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_q_heads: Optional[int], window: Optional[int],
                  scale: float) -> torch.Tensor:
    """One launch of a compiled (q/k, v) head-dim instance."""
    folded = n_q_heads is not None
    nd = 3 if folded else 4
    (qp, qs), (kp, ks), (vp, vs) = (_rows(q, "q", nd), _rows(k, "k", nd),
                                    _rows(v, "v", nd))
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("flash_attention: q, k and v must share a device")
    hd_v = v.shape[-1]
    if folded:
        B, H, Hkv, _ = _heads(q, k, n_q_heads)
        _, sq, hd = q.shape
        sk = k.shape[1]
        # (b, s, h) of a folded row lies at (b·H + h)·s0 + s·s1
        q_st = (H * qs[0], qs[1], qs[0])
        k_st = (Hkv * ks[0], ks[1], ks[0])
        v_st = (Hkv * vs[0], vs[1], vs[0])
        out = torch.empty((B * H, sq, hd_v), dtype=q.dtype, device=q.device)
        o_st = (H * sq * hd_v, hd_v, sq * hd_v)
    else:
        B, sq, H, hd = q.shape
        sk, Hkv = k.shape[1], k.shape[2]
        if k.shape[0] != B or H % Hkv:
            raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                             f"{tuple(k.shape)} differ in batch, or the "
                             f"heads are no multiple of the KV heads")
        q_st, k_st, v_st = qs[:3], ks[:3], vs[:3]
        out = torch.empty((B, sq, H, hd_v), dtype=q.dtype, device=q.device)
        o_st = (sq * H * hd_v, H * hd_v, hd_v)
    if sq < 1 or sk < 1 or -(-sq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: needs Sq, Sk >= 1 and at most "
                         f"65535 query tiles; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    _FLASH(qp, kp, vp, out.data_ptr(), *q_st, *k_st, *v_st, *o_st, B, sq,
           sk, hd, hd_v, H, Hkv, _check_window(window), scale, stream_of(q))
    return out


#: q (B·H, Sq, hd), k (B·Hkv, Sk, hd) and v (B·Hkv, Sk, hd_v) with
#: ``n_q_heads`` given, or the model's q (B, Sq, H, hd), k (B, Sk, Hkv, hd)
#: and v (B, Sk, Hkv, hd_v) without it; the result (head dim hd_v) in the
#: same layout as q, contiguous
flash_attention_kernel = register_kernel(
    "flash_attention", plain=_plain, launch=_flash_cuda)

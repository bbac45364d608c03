"""Model-layout flash attention: q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd).

The port of the JAX package's ``kernels/flash_attention/ops.py``. The
wrapper folds heads into the batch, as the reference's ``_fold`` does,
into contiguous (B·H, S, hd) copies, since the kernel takes contiguous
tensors, and unfolds the result. The op is a ``torch.autograd.Function``
whose backward raises: the reference's Pallas kernel has no backward
either, and training through it waits for a backward kernel (ROADMAP
Queue 1, DecByzPG with the transformer policy). Nothing routes a
gradient through the plain version instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_kernel)


def _fold(x: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def _unfold(x: torch.Tensor, B: int) -> torch.Tensor:
    BH, S, hd = x.shape
    return x.reshape(B, BH // B, S, hd).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_q_heads, window):
        return flash_attention_kernel(q, k, v, n_q_heads, window)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention has no backward: training through it (DecByzPG "
            "with the transformer policy, ROADMAP Queue 1) needs a backward "
            "kernel, which is not written yet")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H, hd), (B, Sk, Hkv, hd) x2 -> (B, Sq, H, hd); causal on
    absolute positions ``0..Sq-1`` and ``0..Sk-1``."""
    B, _, H, _ = q.shape
    out = _FlashAttention.apply(_fold(q), _fold(k), _fold(v), H, window)
    return _unfold(out, B)

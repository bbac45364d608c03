"""Model-layout flash attention: q (B, Sq, H, hd), k (B, Sk, Hkv, hd) and
v (B, Sk, Hkv, hd_v).

The port of the JAX package's ``kernels/flash_attention/ops.py``. On a
CUDA tensor the kernel reads q, k and v through their strides and writes
a contiguous (B, Sq, H, hd_v) result, so nothing is folded into copies or
unfolded back (the reference's ``_fold``); on a CPU tensor the plain
version folds, as the reference does. v's head dim may be narrower than
q's and k's: MLA's sequence pass (``models/attention.py``
``mla_forward``, serving's prefill) hands over q/k 192 and v 128
(DeepSeek-V2-Lite) or 96 and 64 (MiniCPM3-4B); GQA's passes one head dim.
The op is a ``torch.autograd.Function`` whose backward raises: the
reference's Pallas kernel has no backward either, and its models never
differentiate it. Training runs the models' ``attention="chunked"`` route
(``models/attention.py``), the reference's plain route, which autograd
differentiates. Nothing routes a gradient through this op's plain
version instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_kernel)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        return flash_attention_kernel(q, k, v, window=window)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention has no backward: it is the forward-only route; "
            "training runs the models' attention='chunked' route, which "
            "autograd differentiates")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd_v) -> (B, Sq,
    H, hd_v); causal on absolute positions ``0..Sq-1`` and ``0..Sk-1``."""
    return _FlashAttention.apply(q, k, v, window)

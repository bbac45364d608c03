"""Gram matrix and pairwise squared distances of stacked vectors.

``gram`` maps a (Bt, K, d) float32 stack to its (Bt, K, K) Gram matrices
``X Xᵀ``. On a CUDA tensor it launches ``gram_chunk_kernel`` (and, for
d > :data:`GRAM_CHUNK`, ``gram_reduce_kernel``) from
``kernels/csrc/aggregation.cu``, the counterpart of the JAX package's
``kernels/pairwise_dist/pairwise_dist.py::gram``; on a CPU tensor it runs
:func:`gram_plain`, the same chunked algorithm in PyTorch.

``pairwise_sq_dists`` is plain tensor code on top
(:func:`sq_dists_from_gram`): D² = diag + diagᵀ − 2G, clamped at 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_stack, register_kernel, \
    stream_of

#: coordinates per chunk of the plan
GRAM_CHUNK = 8192
#: lanes of the second pass's fixed summation order
_LANES = 32


def gram_chunks(d: int) -> range:
    """The plan of ``gram``, for the kernel and :func:`gram_plain` alike:
    the chunks' first coordinates. Chunk ``lo`` covers
    ``[lo, min(lo + step, d))``, the last one ragged. It depends on d
    alone, so a result's bits depend only on the input."""
    return range(0, d, GRAM_CHUNK)


def _partials(x: torch.Tensor) -> torch.Tensor:
    """(Bt, K, n) -> (Bt, K, K) sums over the last axis of every row's
    products with every row; (i, j) and (j, i) sum the same products in
    the same order, so the result is exactly symmetric."""
    return torch.stack([(x * x[:, i:i + 1]).sum(-1)
                        for i in range(x.shape[1])], dim=1)


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, K, K) under the kernel's plan: one partial Gram
    matrix per chunk of :func:`gram_chunks`, then, with more than one
    chunk, the kernel's second pass: lane l of 32 sums chunks l, l + 32,
    ... in sequence, and the lanes meet in a xor butterfly."""
    x = x.to(torch.float32)
    bt, k, d = x.shape
    plan = gram_chunks(d)
    n = len(plan)
    if n == 1:
        return _partials(x)
    xc = F.pad(x, (0, n * plan.step - d)).reshape(bt, k, n, plan.step)
    part = _partials(xc).permute(0, 3, 1, 2)
    # part (Bt, n, K, K); lane l takes chunks l, l + 32, ... (zeros past n)
    part = F.pad(part, (0, 0, 0, 0, 0, -n % _LANES))
    part = part.reshape(bt, -1, _LANES, k, k)
    s = torch.zeros_like(part[:, 0])
    for m in range(part.shape[1]):
        s = s + part[:, m]
    # lane l adds lane l ^ off for off = 16, 8, 4, 2, 1: the halves pair up
    # the same way, and a + b == b + a bit for bit
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


_GRAM = _build.CFunction("repro_gram_f32", "gram")


def _gram_cuda(x: torch.Tensor) -> torch.Tensor:
    bt, k, d = check_stack(x, "gram", _build.KMAX)
    out = torch.empty((bt, k, k), device=x.device, dtype=torch.float32)
    plan = gram_chunks(d)
    n = len(plan)
    ws = None if n == 1 else torch.empty(
        (bt, k * (k + 1) // 2, n), device=x.device, dtype=torch.float32)
    _GRAM(x.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
          bt, k, d, plan.step, n, stream_of(x))
    return out


gram = register_kernel("gram", plain=gram_plain, launch=_gram_cuda)


def sq_dists_from_gram(g: torch.Tensor) -> torch.Tensor:
    """(..., K, K) Gram matrices -> squared distances ``G_ii + G_jj −
    2 G_ij``, clamped at 0."""
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * g
    return torch.clamp_min(d2, 0.0)


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, K, K) squared euclidean distances, float32."""
    return sq_dists_from_gram(gram(x))

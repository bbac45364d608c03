"""Gram matrix and pairwise squared distances of stacked vectors.

``gram`` maps a (Bt, K, d) float32 stack to its (Bt, K, K) Gram matrices
``X Xᵀ``. On a CUDA tensor it launches ``gram_kernel`` from
``kernels/csrc/aggregation.cu`` (the counterpart of the JAX package's
``kernels/pairwise_dist/pairwise_dist.py::gram``); on a CPU tensor it runs
:func:`gram_plain`, the same row-by-row products in PyTorch.

``pairwise_sq_dists`` is plain tensor code on top: D² = diag + diagᵀ − 2G,
clamped at 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_stack, register_kernel, \
    stream_of


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, K, K): row i of each Gram matrix is the sum over
    d of row i's products with every row, as the kernel's block i does."""
    x = x.to(torch.float32)
    return torch.stack([(x * x[:, i:i + 1, :]).sum(-1)
                        for i in range(x.shape[1])], dim=1)


def _gram_cuda(x: torch.Tensor) -> torch.Tensor:
    check_stack(x, "gram", _build.KMAX)
    bt, k, d = x.shape
    out = torch.empty((bt, k, k), device=x.device, dtype=torch.float32)
    lib = _build.library()
    _build.check(lib.repro_gram_f32(x.data_ptr(), out.data_ptr(), bt, k, d,
                                    stream_of(x)), "gram")
    return out


gram = register_kernel("gram", plain=gram_plain, launch=_gram_cuda)


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, K, K) squared euclidean distances, float32."""
    g = gram(x)
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * g
    return torch.clamp_min(d2, 0.0)

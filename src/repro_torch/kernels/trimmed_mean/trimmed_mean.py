"""Coordinate-wise trimmed mean over the agent axis.

``trimmed_mean(x (Bt, K, d), n_trim) -> (Bt, d)``: per coordinate, the
mean of the values at ranks ``[n_trim, K - n_trim)`` among the K agents.
On a CUDA tensor it launches ``trimmed_mean_kernel`` from
``kernels/csrc/cw_reduce.cu`` (the counterpart of the JAX package's
``kernels/trimmed_mean/trimmed_mean.py::trimmed_mean_pallas``); on a CPU
tensor it runs :func:`trimmed_mean_plain`. Both rank the agent axis as the
Pallas kernel does: padded to a multiple of 8, pad slots last
(``cw_reduce(..., n_valid=K)``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_stack, register_kernel, \
    stream_of
from repro_torch.kernels.gossip_reduce.cw_reduce import (cw_instance,
                                                         cw_reduce_plain)


def _check_trim(k: int, n_trim: int) -> None:
    if not 0 <= 2 * n_trim < k:
        raise ValueError(f"trimmed_mean needs K > 2*n_trim >= 0, got K={k}, "
                         f"n_trim={n_trim}")


def trimmed_mean_plain(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, d), through the shared rank network."""
    k = x.shape[1]
    _check_trim(k, n_trim)
    kp = -(-k // 8) * 8
    xp = F.pad(x.to(torch.float32), (0, 0, 0, kp - k))
    return cw_reduce_plain(xp.transpose(0, 1), "trimmed", n_trim, n_valid=k)


_TRIMMED_MEAN = _build.CFunction("repro_trimmed_mean_f32", "trimmed_mean")


def _trimmed_mean_cuda(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    bt, k, d = check_stack(x, "trimmed_mean", _build.KMAX)
    _check_trim(k, n_trim)
    out = torch.empty((bt, d), device=x.device, dtype=torch.float32)
    _TRIMMED_MEAN(x.data_ptr(), out.data_ptr(), bt, k, d, int(n_trim),
                  cw_instance(k), stream_of(x))
    return out


trimmed_mean = register_kernel("trimmed_mean", plain=trimmed_mean_plain,
                               launch=_trimmed_mean_cuda)

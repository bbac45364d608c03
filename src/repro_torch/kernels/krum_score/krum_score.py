"""Krum scores: per agent, the sum of its ``n_near`` smallest squared
distances to the others.

``krum_scores(x (Bt, K, d), n_near) -> (Bt, K)`` is two launches: the
``gram`` kernel, then ``krum_score`` on the (Bt, K, K) Gram matrices. The
scoring forms ``d2_ij = max(G_ii + G_jj − 2 G_ij, 0)`` (exactly 0 on the
diagonal), ranks each row with the column tie-break over the row padded
to a multiple of 8 (pad columns last), and sums the entries at ranks
``[1, n_near]``: rank 0 is the self-distance. On a CUDA tensor it launches
``krum_score_kernel`` from ``kernels/csrc/cw_reduce.cu`` (the counterpart
of the JAX package's ``kernels/krum_score/krum_score.py::
krum_scores_pallas``), one thread a row through the cw reduces' rank
network of height ``cw_instance(K)``; on a CPU tensor it runs
:func:`krum_score_plain`, the same ranks, which also sums in the kernel's
butterfly order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import register_kernel, stream_of
from repro_torch.kernels.gossip_reduce.cw_reduce import PAD_BIG, \
    cw_instance
from repro_torch.kernels.pairwise_dist.pairwise_dist import gram


def krum_score_plain(g: torch.Tensor, n_near: int) -> torch.Tensor:
    """(Bt, K, K) Gram matrices -> (Bt, K) Krum scores."""
    k = g.shape[-1]
    kp = -(-k // 8) * 8
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * g, 0.0)
    xv = F.pad(d2, (0, kp - k), value=PAD_BIG)           # (Bt, K, kp)
    col = torch.arange(kp, device=g.device)
    kept = torch.zeros(d2.shape[:-1] + (32,), dtype=d2.dtype,
                       device=d2.device)
    for b in range(k):
        e = xv[..., b:b + 1]
        rank = ((xv < e) | ((xv == e) & (col < b))).sum(-1)
        kept[..., b] = torch.where((rank >= 1) & (rank <= n_near),
                                   d2[..., b], 0.0)
    # halves of 32 slots: the kernel's tree over fewer slots (a power of two
    # >= K) gives the same bits, since the halvings it skips add +0 to
    # values that are never -0 where the score is 0
    while kept.shape[-1] > 1:
        half = kept.shape[-1] // 2
        kept = kept[..., :half] + kept[..., half:]
    return kept[..., 0]


_KRUM_SCORE = _build.CFunction("repro_krum_score_f32", "krum_score")


def _krum_score_cuda(g: torch.Tensor, n_near: int) -> torch.Tensor:
    if g.dtype != torch.float32:
        raise TypeError(f"krum_score: expected float32, got {g.dtype}")
    if g.dim() != 3 or g.shape[1] != g.shape[2] or g.shape[0] < 1 \
            or not 1 <= g.shape[1] <= _build.KMAX:
        raise ValueError(f"krum_score: expected (Bt, K, K) Gram matrices "
                         f"with 1 <= K <= {_build.KMAX}, got shape "
                         f"{tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("krum_score: expected a contiguous tensor")
    bt, k, _ = g.shape
    out = torch.empty((bt, k), device=g.device, dtype=torch.float32)
    _KRUM_SCORE(g.data_ptr(), out.data_ptr(), bt, k, int(n_near),
                cw_instance(k), stream_of(g))
    return out


krum_score = register_kernel("krum_score", plain=krum_score_plain,
                             launch=_krum_score_cuda)


def krum_scores(x: torch.Tensor, n_near: int) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, K) Krum scores: gram, then krum_score."""
    return krum_score(gram(x), n_near)

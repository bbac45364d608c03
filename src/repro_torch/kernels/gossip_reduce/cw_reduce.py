"""The coordinate-wise reduce body shared by the trimmed-mean and gossip
kernels: the port's own copy of the JAX package's
``kernels/gossip_reduce/ref.py`` (``MODES``, ``check_mode``,
``cw_reduce``).

:func:`cw_reduce_plain` is the plain PyTorch version of the reduce in
``kernels/csrc/cw_reduce.cu``: the same ranks (an O(P²) network, no sort),
the same tie and pad rules, and the kept values summed in the same slot
order, so on equal inputs the two give the same bits. :func:`cw_instance`
is the kernels' plan: which compiled rank network a launch takes.
"""
from __future__ import annotations

from typing import Optional

import torch

MODES = ("mean", "median", "trimmed")
#: the mode's number in the C interface (``CW_MEAN`` ... in the source)
MODE_IDS = {m: i for i, m in enumerate(MODES)}
#: the value pad slots rank with: after every finite value
PAD_BIG = 3.4e38
#: the heights the rank network is compiled for: exact (P fixed at compile
#: time: ring(k=4)'s 5 and the complete graph's 13 at K = 13) and padded
#: (any P up to the height, read at run time)
EXACT_HEIGHTS = (5, 13)
PADDED_HEIGHTS = (8, 16, 32)


def cw_instance(p: int) -> int:
    """The height of the rank network for ``p`` slots: ``p`` itself where
    an exact instance exists, else the smallest padded height >= p."""
    if p in EXACT_HEIGHTS:
        return p
    for h in PADDED_HEIGHTS:
        if p <= h:
            return h
    raise ValueError(f"no rank network holds P={p} slots (P <= "
                     f"{PADDED_HEIGHTS[-1]})")


def check_mode(mode: str, deg_max: int, n_trim: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown gossip reduce mode {mode!r}; "
                         f"expected one of {MODES}")
    if mode == "trimmed" and not 0 <= 2 * n_trim < deg_max:
        raise ValueError(f"trimmed gossip reduce needs deg_max > 2*n_trim, "
                         f"got deg_max={deg_max}, n_trim={n_trim}")


def cw_reduce_plain(v: torch.Tensor, mode: str, n_trim: int,
                    n_valid: Optional[int] = None) -> torch.Tensor:
    """Coordinate-wise reduce of ``v (P, ..., d)`` over its leading axis.

    Slots ``>= n_valid`` (default: none) are pad: ranked last and never
    kept. The rank of a valid slot b counts the slots a ordered before it,
    ``xv[a] < v[b]`` or equal with ``a < b``, where ``xv`` holds
    :data:`PAD_BIG` in the pad slots: the masked values on the left, the
    unmasked ones on the right, as the reference writes it.
    """
    P = v.shape[0]
    n = P if n_valid is None else n_valid
    v = v.to(torch.float32)
    s = torch.zeros_like(v[0])
    if mode == "mean":
        for a in range(n):
            s = s + v[a]
        return _divide(s, n)
    xv = v.clone()
    xv[n:] = PAD_BIG
    slot = torch.arange(P, device=v.device).view((P,) + (1,) * (v.dim() - 1))
    median = mode == "median"
    lo, hi = ((n - 1) // 2, n // 2) if median else (n_trim, n - n_trim - 1)
    s_hi = torch.zeros_like(v[0])
    for b in range(n):
        rank = ((xv < v[b]) | ((xv == v[b]) & (slot < b))).sum(0)
        if median:
            s = s + torch.where(rank == lo, v[b], 0.0)
            s_hi = s_hi + torch.where(rank == hi, v[b], 0.0)
        else:
            s = s + torch.where((rank >= lo) & (rank <= hi), v[b], 0.0)
    return 0.5 * (s + s_hi) if median else _divide(s, n - 2 * n_trim)


def _divide(s: torch.Tensor, n: int) -> torch.Tensor:
    """``s / n`` rounded once, as the kernel's IEEE division: on CUDA,
    PyTorch divides by a Python number through its reciprocal, which can
    differ by an ulp, so the divisor is a tensor on ``s``'s device."""
    return s / torch.tensor(float(n), dtype=s.dtype, device=s.device)

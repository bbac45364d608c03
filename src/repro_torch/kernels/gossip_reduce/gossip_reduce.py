"""Gossip reduces of the coordinate-wise agreement rounds.

* ``gossip_reduce(msgs (K, d), nbr (K, P) int64, mode, n_trim) -> (K, d)``:
  every receiver r gathers the rows ``msgs[nbr[r]]`` and reduces them
  coordinate-wise, in one launch (the counterpart of the JAX package's
  ``kernels/gossip_reduce/gossip_reduce.py::gossip_reduce_pallas``);
* ``neighbor_reduce(recv (K, P, d), mode, n_trim) -> (K, d)``: the same
  reduce over an already gathered tensor, the per-receiver equivocation
  path (``neighbor_reduce_pallas``).

On a CUDA tensor each launches its kernel from ``kernels/csrc/
cw_reduce.cu``, at the rank network :func:`~repro_torch.kernels.
gossip_reduce.cw_reduce.cw_instance` picks for P; on a CPU tensor it runs
its plain version, the gather and :func:`~repro_torch.kernels.
gossip_reduce.cw_reduce.cw_reduce_plain`. ``mode`` is ``"mean"``,
``"median"`` or ``"trimmed"``; ``check_mode``'s errors come first, then
the kernels' limits (P <= 32).
``nbr`` must index rows of ``msgs``. The kernel cannot raise without a
device sync, so a receiver with an index outside ``[0, K)`` gets a NaN
row instead of a read past ``msgs``; the plain version indexes as
PyTorch does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import register_kernel, stream_of
from repro_torch.kernels.gossip_reduce.cw_reduce import (MODE_IDS,
                                                         check_mode,
                                                         cw_instance,
                                                         cw_reduce_plain)


def gossip_reduce_plain(msgs: torch.Tensor, nbr: torch.Tensor,
                        mode: str = "mean", n_trim: int = 0) -> torch.Tensor:
    check_mode(mode, nbr.shape[1], n_trim)
    return cw_reduce_plain(msgs[nbr].transpose(0, 1), mode, n_trim)


def neighbor_reduce_plain(recv: torch.Tensor, mode: str = "mean",
                          n_trim: int = 0) -> torch.Tensor:
    check_mode(mode, recv.shape[1], n_trim)
    return cw_reduce_plain(recv.transpose(0, 1), mode, n_trim)


def _check_values(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != ndim or min(x.shape) < 1:
        raise ValueError(f"{name}: expected a non-empty {ndim}-d tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: {x.shape[0]} receivers exceed the grid's "
                         f"65535")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_width(name: str, p: int) -> None:
    if p > _build.KMAX:
        raise ValueError(f"{name}: needs P <= {_build.KMAX} neighbours, got "
                         f"P={p}")


_GOSSIP_REDUCE = _build.CFunction("repro_gossip_reduce_f32", "gossip_reduce")
_NEIGHBOR_REDUCE = _build.CFunction("repro_neighbor_reduce_f32",
                                    "neighbor_reduce")


def _gossip_reduce_cuda(msgs: torch.Tensor, nbr: torch.Tensor,
                        mode: str = "mean", n_trim: int = 0) -> torch.Tensor:
    check_mode(mode, nbr.shape[1], n_trim)
    _check_values(msgs, "gossip_reduce", 2)
    k, d = msgs.shape
    if nbr.dtype != torch.int64 or nbr.dim() != 2 or nbr.shape[0] != k \
            or nbr.device != msgs.device or not nbr.is_contiguous():
        raise ValueError(f"gossip_reduce: nbr must be a contiguous int64 "
                         f"({k}, P) tensor on {msgs.device}, got "
                         f"{tuple(nbr.shape)} {nbr.dtype} on {nbr.device}")
    p = nbr.shape[1]
    _check_width("gossip_reduce", p)
    out = torch.empty((k, d), device=msgs.device, dtype=torch.float32)
    _GOSSIP_REDUCE(msgs.data_ptr(), nbr.data_ptr(), out.data_ptr(), k, p, d,
                   MODE_IDS[mode], int(n_trim), cw_instance(p),
                   stream_of(msgs))
    return out


def _neighbor_reduce_cuda(recv: torch.Tensor, mode: str = "mean",
                          n_trim: int = 0) -> torch.Tensor:
    check_mode(mode, recv.shape[1], n_trim)
    _check_values(recv, "neighbor_reduce", 3)
    k, p, d = recv.shape
    _check_width("neighbor_reduce", p)
    out = torch.empty((k, d), device=recv.device, dtype=torch.float32)
    _NEIGHBOR_REDUCE(recv.data_ptr(), out.data_ptr(), k, p, d,
                     MODE_IDS[mode], int(n_trim), cw_instance(p),
                     stream_of(recv))
    return out


gossip_reduce = register_kernel("gossip_reduce", plain=gossip_reduce_plain,
                                launch=_gossip_reduce_cuda)
neighbor_reduce = register_kernel("neighbor_reduce",
                                  plain=neighbor_reduce_plain,
                                  launch=_neighbor_reduce_cuda)

"""The carrier of a D-sharded (K, D) stack: a ``torch.distributed.tensor.
DTensor`` whose last axis (D) is split by ``Shard`` over one mesh
dimension and replicated over the others (the reference's ``P(None,
"model")``).

Code that takes such a stack works on the rank's local columns
(:func:`local_columns`) and wraps a result whose last axis is those
columns back (:meth:`Shards.wrap`, :func:`rewrap`). What needs all of D (a
Gram matrix, a sum of squares, a row) is a local partial combined by one
``all_gather`` and a sum in rank order (:meth:`Shards.sum`,
:meth:`Shards.gather_row`), so every rank holds the same bits;
``all_reduce`` promises no order. No DTensor operator runs. A plain tensor
is the stack with one shard: ``local_columns`` gives it back with no
:class:`Shards`, and nothing is combined.

This module holds no kernel and no registry: the aggregators
(:mod:`repro_torch.core.aggregators`), the agreement rounds
(:mod:`repro_torch.core.agreement`), the flat layer and the flat trainer
(:mod:`repro_torch.distributed`) build on it.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


def is_dtensor(x) -> bool:
    """A DTensor, found without importing the DTensor module: none can
    exist before it is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _chunk(D: int, n: int, i: int) -> tuple:
    """Columns ``[lo, hi)`` of shard i of n over D, as ``torch.chunk``
    splits (and DTensor's ``Shard`` places): ⌈D/n⌉ each, the last shards
    short or empty."""
    step = -(-D // n)
    lo = min(i * step, D)
    return lo, min(lo + step, D)


def gather_over(t: torch.Tensor, mesh, dim: int) -> list:
    """Every rank's ``t`` (the same shape on each), in rank order over the
    mesh dimension ``dim``: one ``all_gather``. Under NCCL (each rank on
    its own card) the parts are made and gathered on the card, and the
    call returns once the rank's current stream waits for the gather, so
    what follows on that stream reads them; no byte crosses the host. A
    gloo group takes no CUDA tensor in ``all_gather`` (ranks that share
    a GPU run gloo: NCCL refuses them), so there ``t`` is staged through
    the host and the parts stay there; the sums that follow are the same
    IEEE operations on either device, so both routes give the same
    bits."""
    group = mesh.get_group(dim)
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(dim))]
    dist.all_gather(parts, src, group=group)
    return parts


class Shards(NamedTuple):
    """Where a stack's last axis lives: the ``mesh``, the mesh dimension
    ``dim`` that splits it (None: replicated), the global width ``D`` and
    this rank's columns ``[lo, hi)``."""
    mesh: object
    dim: Optional[int]
    D: int
    lo: int
    hi: int

    @property
    def size(self) -> int:
        """Ranks sharing the columns: the split dimension's size."""
        return 1 if self.dim is None else self.mesh.size(self.dim)

    def wrap(self, local: torch.Tensor):
        """A result whose last axis is this rank's columns -> the DTensor
        of width D, split over ``dim`` on its last axis and replicated
        over the mesh's other dimensions (no collective)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        places = [Replicate()] * self.mesh.ndim
        if self.dim is not None:
            places[self.dim] = Shard(local.dim() - 1)
        shape = tuple(local.shape[:-1]) + (self.D,)
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(local, self.mesh, places, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))

    def sum(self, partial: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of each rank's ``partial``, in rank order, on
        every rank (``all_reduce`` promises no order); ``partial`` itself
        with one shard."""
        if self.size == 1:
            return partial
        parts = gather_over(partial, self.mesh, self.dim)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total.to(partial.device)

    def gather_row(self, row: torch.Tensor) -> torch.Tensor:
        """This rank's columns of one row -> the whole (D,) row, the
        shards concatenated in rank order (each padded to ⌈D/n⌉ for the
        gather)."""
        if self.size == 1:
            return row
        step = -(-self.D // self.size)
        buf = row.new_zeros(step)
        buf[:row.shape[0]] = row
        parts = gather_over(buf, self.mesh, self.dim)
        return torch.cat(parts)[:self.D].to(row.device)


def local_columns(x):
    """``(local, shards)``: a DTensor's local tensor and its
    :class:`Shards`, or a plain tensor and None. The DTensor must be
    replicated over every mesh dimension but at most one, which splits
    its last axis."""
    if not is_dtensor(x):
        return x, None
    from torch.distributed.tensor import Replicate, Shard
    ax, split = x.dim() - 1, None
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.dim() == ax and split is None:
            split = i
        elif not isinstance(p, Replicate):
            raise ValueError(f"a D-sharded stack is split along its last "
                             f"axis over one mesh dimension and replicated "
                             f"over the others; got placements "
                             f"{x.placements}")
    mesh, D = x.device_mesh, x.shape[-1]
    lo, hi = (0, D) if split is None else _chunk(
        D, mesh.size(split), mesh.get_local_rank(split))
    local = x.to_local()
    if local.shape[-1] != hi - lo:
        raise ValueError(f"local shard of width {local.shape[-1]}, expected "
                         f"columns [{lo}, {hi}) of {D}")
    return local, Shards(mesh, split, D, lo, hi)


def rewrap(out: torch.Tensor, sh: Optional[Shards]):
    """A result whose last axis is the local columns, back in the input's
    form: as is for a plain input (``sh`` None), else wrapped."""
    return out if sh is None else sh.wrap(out)


def on_columns(fn, x, *args):
    """``fn(local, *args)`` on a stack's local columns, its result (whose
    last axis is those columns) wrapped back; a plain tensor's as is. For
    column-wise functions only."""
    local, sh = local_columns(x)
    return rewrap(fn(local, *args), sh)


def norms(local: torch.Tensor, sh: Optional[Shards]) -> torch.Tensor:
    """The euclidean norms over the last axis of ``local``, a stack's
    local columns: the rank's sums of squares summed over the ranks
    (``torch.linalg.vector_norm`` with one shard)."""
    if sh is None:
        return torch.linalg.vector_norm(local, dim=-1)
    return torch.sqrt(sh.sum((local * local).sum(-1)))


def row_norms(x) -> torch.Tensor:
    """(K, D) plain or D-sharded -> the (K,) euclidean norms of the rows,
    the same on every rank."""
    return norms(*local_columns(x))


def dim_sharded(x, axis: int = -1) -> bool:
    """True when ``x`` is a DTensor whose ``axis`` is split by ``Shard``
    over mesh dimensions of more than one rank in all; False for a plain
    tensor, a replicated DTensor and a split over a dimension of size
    1."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    ax = axis % max(x.dim(), 1)
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.dim() == ax:
            n *= x.device_mesh.size(i)
    return n > 1


def shard_columns(t: torch.Tensor, mesh, placements):
    """A tensor every rank holds whole -> the DTensor of ``placements``
    (:func:`repro_torch.distributed.fed_trainer.flat_param_sharding`),
    each rank keeping a contiguous copy of its columns (no collective,
    unlike ``distribute_tensor``'s scatter)."""
    from torch.distributed.tensor import Shard
    split = [i for i, p in enumerate(placements) if isinstance(p, Shard)]
    if not split:
        return t
    if len(split) > 1 or placements[split[0]].dim % t.dim() != t.dim() - 1:
        raise ValueError(f"shard_columns splits the last axis over one mesh "
                         f"dimension; got {placements}")
    i = split[0]
    lo, hi = _chunk(t.shape[-1], mesh.size(i), mesh.get_local_rank(i))
    return Shards(mesh, i, t.shape[-1], lo, hi).wrap(
        t[..., lo:hi].contiguous())

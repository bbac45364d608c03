"""The carrier of a placed leaf: a ``torch.distributed.tensor.DTensor``
whose dimensions are split by ``Shard`` over mesh dimensions and
replicated over the others, as the leaf placement rules of
:mod:`repro_torch.distributed.sharding` put an agent-stacked parameter:
dimension 0 (the K agents) over the federation dimensions, trailing
dimensions over "model" (and a layer stack over "data").

Every split must divide its dimension, so each rank holds one equal
block per dimension; DTensor applies the shards of one dimension in
mesh-dimension order, the first major (the reference's order for a tuple
of axes). :class:`Layout` says which block a rank holds.

Code that takes such a leaf works on its local block
(``DTensor.to_local()``; no DTensor operator runs) and wraps a result of
the same layout back (:meth:`Layout.wrap`). What needs more than the
block gathers it: :func:`gather` puts dimensions back together, inner
mesh dimension first, by ``all_gather`` in rank order; :func:`layer_block`
takes one layer of a layer-stacked leaf as the rank holds it (from the
rank that holds it, where the layers are split); :func:`rank_sum` adds
partials over mesh dimensions in rank order, so every rank holds the
same bits (``all_reduce`` promises no order). A mesh dimension of size 1
costs no collective, so on a one-rank mesh every function here is the
plain tensor's operation.

Autograd goes through each of them, so that a rank's forward and
backward run on its blocks: :func:`rank_sum`'s backward is the identity
and its conjugate :func:`enter` (the identity forward) sums the ranks'
partial gradients in rank order; :func:`gather`'s backward keeps the
rank's block of the whole gradient; :func:`layer_block`'s brings a
layer's gradient to the rank that holds it. Every one stays an
``all_gather`` summed in rank order, so a rank's bits do not depend on
its rank. The D-sharded bare stack of the flat trainer is
:mod:`repro_torch.carriers.columns`' carrier; this one is the tree
trainer's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.carriers.columns import gather_over, is_dtensor


class Layout(NamedTuple):
    """Where a placed leaf lives: the ``mesh``, its global ``shape`` and,
    per tensor dimension, the mesh dimensions that split it (major
    first; empty: whole on every rank)."""
    mesh: object
    shape: Tuple[int, ...]
    splits: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, shape, mesh, places) -> "Layout":
        """The layout of ``places`` (DTensor placements, ``Shard`` and
        ``Replicate`` only) for a tensor of ``shape`` on ``mesh``."""
        from torch.distributed.tensor import Replicate, Shard
        shape = tuple(shape)
        splits = [[] for _ in shape]
        for i, p in enumerate(places):
            if isinstance(p, Shard):
                splits[p.dim % len(shape)].append(i)
            elif not isinstance(p, Replicate):
                raise ValueError(f"a placed leaf is split or replicated; "
                                 f"got {tuple(places)}")
        lay = cls(mesh, shape, tuple(tuple(s) for s in splits))
        for d, n in enumerate(shape):
            if n % lay.parts(d):
                raise ValueError(f"dimension {d} of {shape} does not divide "
                                 f"into {lay.parts(d)} blocks ({places})")
        return lay

    def parts(self, d: int) -> int:
        """The number of blocks of dimension d."""
        n = 1
        for m in self.splits[d]:
            n *= self.mesh.size(m)
        return n

    def block(self, d: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of dimension d."""
        coord = self.mesh.get_coordinate()
        idx = 0
        for m in self.splits[d]:
            idx = idx * self.mesh.size(m) + coord[m]
        step = self.shape[d] // self.parts(d)
        return idx * step, (idx + 1) * step

    def index(self, first: int = 0) -> tuple:
        """Slices of this rank's block over dimensions ``first``...,
        for indexing a whole tensor."""
        return tuple(slice(*self.block(d))
                     for d in range(first, len(self.shape)))

    @property
    def trailing(self) -> Tuple[int, ...]:
        """The mesh dimensions that split a dimension past the first."""
        return tuple(sorted({m for ms in self.splits[1:] for m in ms}))

    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * self.mesh.ndim
        for d, ms in enumerate(self.splits):
            for m in ms:
                out[m] = Shard(d)
        return tuple(out)

    def wrap(self, local: torch.Tensor):
        """This rank's block -> the DTensor of this layout (no
        collective)."""
        from torch.distributed.tensor import DTensor
        stride, acc = [], 1
        for n in reversed(self.shape):
            stride.append(acc)
            acc *= n
        return DTensor.from_local(local, self.mesh, self.placements(),
                                  run_check=False,
                                  shape=torch.Size(self.shape),
                                  stride=tuple(reversed(stride)))

    def without_first(self) -> "Layout":
        """The layout of one agent's leaf (dimension 0 dropped; the mesh
        dimensions that split it now replicate)."""
        return Layout(self.mesh, self.shape[1:], self.splits[1:])

    def agents(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's agents' values (dimension 0 this layout's block of
        it) -> all K agents', gathered over the federation dimensions in
        rank order, the same on every rank."""
        lay = Layout(self.mesh, (self.shape[0],) + tuple(t.shape[1:]),
                     (self.splits[0],) + ((),) * (t.dim() - 1))
        return gather(t, lay, [0])


def layout(x) -> Optional[Layout]:
    """A DTensor's :class:`Layout`; None for a plain tensor."""
    if not is_dtensor(x):
        return None
    return Layout.of(x.shape, x.device_mesh, x.placements)


def local(x) -> torch.Tensor:
    """A DTensor's block, or the plain tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def place(t: torch.Tensor, mesh, places):
    """A tensor every rank holds whole -> the DTensor of ``places``, each
    rank keeping a copy of its block, so the whole tensor goes when the
    caller lets it go (no collective; a block that is all of ``t``, as on
    a one-rank mesh, is ``t`` itself, not a copy)."""
    lay = Layout.of(t.shape, mesh, places)
    idx = lay.index()
    whole = all(s == slice(0, n) for s, n in zip(idx, t.shape))
    return lay.wrap(t if whole else t[idx].clone())


def gather(block: torch.Tensor, lay: Layout, dims: Sequence[int]
           ) -> torch.Tensor:
    """``block`` (laid out as ``lay`` on the given dimensions; the others
    may be cut) with ``dims`` put back together: per split dimension, an
    ``all_gather`` over each of its mesh dimensions, inner first, the
    parts concatenated in rank order; on the block's device. Under
    autograd the backward keeps this rank's block of the gradient
    (:class:`_Gather`)."""
    dims = tuple(dims)
    if not any(lay.mesh.size(m) > 1 for d in dims for m in lay.splits[d]):
        return block
    return _Gather.apply(block, lay, dims)


def _gather(block: torch.Tensor, lay: Layout, dims: Sequence[int]
            ) -> torch.Tensor:
    out = block
    for d in dims:
        for m in reversed(lay.splits[d]):
            if lay.mesh.size(m) > 1:
                out = torch.cat(gather_over(out, lay.mesh, m), dim=d)
    return out.to(block.device)


def layer_block(t: torch.Tensor, lay: Optional[Layout], i: int,
                rows: Sequence[int] = ()
                ) -> Tuple[torch.Tensor, Optional[Layout]]:
    """Layer ``i`` of a layer-stacked leaf (dimension 0 the layers) as
    this rank holds it: ``t`` its block, laid out as ``lay`` (None: a
    plain tensor). Returns its block past dimension 0 and the
    :class:`Layout` of one layer (None for a plain tensor). Where mesh
    dimensions split the layers (FSDP over "data"), every rank of their
    groups gathers the slice at the same place in its block, one
    ``all_gather`` per mesh dimension, and keeps the one of the rank that
    holds layer ``i`` (the other ranks' slices go).

    Under autograd the backward brings the layer's gradient to the rank
    that holds it: summed in rank order over the mesh dimensions in
    ``rows`` (each rank of such a group computed its own rows, so each
    holds a part of the gradient), as is over the others (every rank of
    the group computed the same); the other ranks' slices get zeros."""
    if lay is None:
        return t[i], None
    per = lay.shape[0] // lay.parts(0)
    piece, owner = t[i % per], i // per
    dims = [m for m in reversed(lay.splits[0]) if lay.mesh.size(m) > 1]
    if dims:
        piece = _LayerSlice.apply(piece, lay.mesh, tuple(dims), owner,
                                  tuple(rows))
    return piece, lay.without_first()


class _LayerSlice(torch.autograd.Function):
    """:func:`layer_block`'s gather of the holder's slice (``dims`` inner
    first, ``owner`` the holder's index over them)."""

    @staticmethod
    def forward(ctx, piece, mesh, dims, owner, rows):
        ctx.mesh, ctx.dims, ctx.rows = mesh, dims, rows
        coord, held = mesh.get_coordinate(), True
        out = piece
        for m in dims:
            n = mesh.size(m)
            out = gather_over(out, mesh, m)[owner % n].to(piece.device)
            held &= coord[m] == owner % n
            owner //= n
        ctx.held = held
        return out

    @staticmethod
    def backward(ctx, grad):
        for m in ctx.dims:
            if m in ctx.rows:
                grad = _sum(grad, ctx.mesh, [m])
        return (grad if ctx.held else torch.zeros_like(grad),
                None, None, None, None)


def _sum(partial: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    out = partial
    for m in dims:
        if mesh.size(m) > 1:
            parts = gather_over(out, mesh, m)
            out = parts[0]             # a buffer of the gather: added into
            for p in parts[1:]:
                out += p
    return out.to(partial.device)


class _RankSum(torch.autograd.Function):
    """:func:`rank_sum` under autograd: the gradient that reaches a sum
    is the same on every rank of its groups (what follows the sum runs
    alike on each), so it passes through as it is."""

    @staticmethod
    def forward(ctx, partial, mesh, dims):
        return _sum(partial, mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Enter(torch.autograd.Function):
    """:func:`enter`: the identity, whose backward is the rank-order sum
    of each rank's partial gradient (the conjugate of :class:`_RankSum`)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh, ctx.dims), None, None


class _Gather(torch.autograd.Function):
    """:func:`gather` under autograd: the backward keeps this rank's block
    of the whole gradient (the gathered tensor is used alike on every
    rank of the groups, so each holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, block, lay, dims):
        ctx.lay, ctx.dims = lay, dims
        return _gather(block, lay, dims)

    @staticmethod
    def backward(ctx, grad):
        idx = [slice(None)] * grad.dim()
        for d in ctx.dims:
            idx[d] = slice(*ctx.lay.block(d))
        return grad[tuple(idx)], None, None


def _split_over(mesh, dims: Sequence[int]) -> list:
    return [m for m in dims if mesh.size(m) > 1]


def rank_sum(partial: torch.Tensor, mesh, dims: Sequence[int]
             ) -> torch.Tensor:
    """Σ of each rank's ``partial`` over the mesh dimensions ``dims``, one
    dimension after another in the given order, each in rank order: the
    same bits on every rank. Under autograd its backward is the identity
    (:class:`_RankSum`)."""
    dims = _split_over(mesh, dims)
    return _RankSum.apply(partial, mesh, tuple(dims)) if dims else partial


def enter(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """``x`` itself, where a tensor that every rank of the groups over
    ``dims`` holds alike enters compute split over them (a column-
    parallel projection, an expert block, a vocabulary block of the
    head): its backward sums each rank's partial gradient in rank order,
    so every rank gets the same whole gradient."""
    dims = _split_over(mesh, dims)
    return _Enter.apply(x, mesh, tuple(dims)) if dims else x


def rank_max(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """The elementwise max of each rank's ``x`` over the mesh dimensions
    ``dims`` (exact in any order; no gradient)."""
    out = x.detach()
    for m in _split_over(mesh, dims):
        out = torch.stack(gather_over(out, mesh, m)).amax(0)
    return out.to(x.device)


def owns(lay: Optional[Layout], dims: Sequence[int]) -> bool:
    """Whether this rank's block of a leaf enters a sum over the mesh
    dimensions ``dims``: a leaf whole along one of them is counted once,
    on the rank at coordinate 0 there; a plain leaf (``lay`` None)
    always."""
    if lay is None:
        return True
    coord = lay.mesh.get_coordinate()
    mine = lay.trailing
    return all(coord[m] == 0 for m in dims if m not in mine)


def tree_layouts(leaves: Sequence) -> Optional[list]:
    """The layouts of a tree's leaves when they are placed (all DTensors);
    None when none is. A tree with some placed leaves raises."""
    lays = [layout(x) for x in leaves]
    if all(lay is None for lay in lays):
        return None
    if any(lay is None for lay in lays):
        raise ValueError("a placed tree has DTensor leaves only")
    return lays

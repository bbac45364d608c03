"""Serving steps: prefill and single-token decode on a mesh, and the
slot-granular cache operations of the continuous-batching engine.

The port of the JAX package's ``distributed/serving.py``.
:func:`make_serve_fns` builds the mesh-sharded prefill and decode of a
:class:`ServeFns`: the parameters placed by the leaf rules of
:mod:`repro_torch.distributed.sharding` (``stacked=False``), the batch
over ("pod", "data") where it divides them (else replicated, as
``long_500k``'s batch of 1), the decode cache by ``cache_shardings`` (K
and V on their heads over "model", or on the ring W where the heads do
not divide; MLA's latent on W). ``long_500k``'s decode shapes take a
sliding-window ring of ``cfg.long_context_window`` (:func:`serve_cache_len`)
and the recurrent families carry O(1) state.

Each rank runs the forward on whole leaves: every split parameter leaf is
gathered whole over the mesh (:func:`repro_torch.carriers.placed.gather`,
``all_gather``s in rank order; no DTensor operator runs), and the rank
computes its own rows of the batch. A tensor-parallel forward on the
blocks is not written (it changes speed, not results). On a one-rank
mesh every split has size 1 and the route runs ``model.prefill`` and
``decode_step`` on the caller's tensors, bit for bit.

``slot_cache_insert`` and ``slot_cache_evict`` write the per-slot cache
in place and return it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from repro_torch.carriers import placed
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map, tree_paths
from repro_torch.distributed.sharding import (PartitionSpec,
                                              cache_shardings,
                                              mesh_axis_size,
                                              param_shardings, place_tree,
                                              placements)
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      prefill)


def serve_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring size for a decode cache over a context of ``seq_len``."""
    if cfg.family == "ssm":
        return 1                       # recurrent state only
    if seq_len > 65536:                # long-context: sliding-window ring
        return cfg.long_context_window
    return seq_len


@dataclasses.dataclass(frozen=True)
class ServeFns:
    """The typed return of :func:`make_serve_fns`.

    * ``prefill(params, tokens[, prefix_embeds]) -> (logits, cache)``
    * ``decode(params, token, cache) -> (logits, cache)``
    * ``shardings``: the :class:`~repro_torch.distributed.sharding.
      PartitionSpec` trees of ``params`` and ``cache`` plus the batch
      spec
    * ``cache_shape`` / ``params_shape``: the trees as tensors on the
      ``meta`` device

    Unpacking as the historical ``(prefill, decode, specs)`` triple still
    works but warns: move to attribute access.
    """
    prefill: Callable
    decode: Callable
    shardings: dict
    cache_shape: Any
    params_shape: Any
    batch_spec: Any

    @property
    def specs(self) -> dict:
        """The legacy specs dict of the ``(fn, fn, dict)`` era."""
        return {"params": self.shardings["params"],
                "cache": self.shardings["cache"],
                "cache_shape": self.cache_shape,
                "params_shape": self.params_shape,
                "batch_spec": self.batch_spec}

    def __iter__(self):
        warnings.warn(
            "unpacking make_serve_fns() as a (prefill, decode, specs) "
            "tuple is deprecated — use the ServeFns fields "
            "(.prefill/.decode/.shardings/.cache_shape/.params_shape)",
            DeprecationWarning, stacklevel=2)
        return iter((self.prefill, self.decode, self.specs))


def _rows(x, lay: placed.Layout):
    """The rank's rows of a batch leaf: a DTensor's block, or the rows of
    ``lay``'s block of a tensor every rank holds whole."""
    if x is None or placed.layout(x) is not None:
        return placed.local(x)
    return x[slice(*lay.block(0))]


def _whole(tree):
    """A placed tree's leaves gathered whole on every rank, in leaf
    order (a leaf no mesh dimension of more than one rank splits is its
    block itself)."""
    def whole(x):
        lay = placed.layout(x)
        return x if lay is None else placed.gather(placed.local(x), lay,
                                                   range(x.dim()))
    return tree_map(whole, tree)


def make_serve_fns(cfg: ModelConfig, mesh, batch: int, seq_len: int,
                   dtype=torch.float32, *, key=None) -> ServeFns:
    """Build mesh-sharded prefill/decode programs as a :class:`ServeFns`.

    The shapes (``params_shape``, ``cache_shape`` with W =
    :func:`serve_cache_len`) are tensors on the ``meta`` device and the
    specs read only the mesh's dimension names and sizes, so an
    :class:`~repro_torch.distributed.sharding.AbstractMesh` serves to
    build them; calling ``prefill`` or ``decode`` needs a ``DeviceMesh``
    of the process group. ``key`` is accepted for the reference's
    signature; the shapes do not depend on it.

    ``prefill(params, tokens[, prefix_embeds])``: ``params`` placed, or
    whole on every rank (placed first, :func:`~repro_torch.distributed.
    sharding.place_tree`); ``tokens`` (B, S_text) int and
    ``prefix_embeds`` (B, P, d), whole or placed on the batch spec. Each
    rank gathers the split leaves whole and runs ``model.prefill(...,
    cache_len=W)`` on its rows; returns the logits placed on the batch
    spec and the cache on the cache specs, each rank keeping its block
    of the cache it computed (no collective; ``pos`` and ``slot_pos``
    plain, the same on every rank).

    ``decode(params, token, cache)``: ``token`` (B,) or (B, 1); a cache
    every rank holds whole is placed first. Each rank gathers its rows
    of the cache whole over the dimensions past the batch, runs
    ``decode_step`` and writes the new ring entry back into its blocks
    (the recurrent states, never split past the rows, are written in
    place): the counterpart of the reference's ``donate_argnums=(2,)``,
    the cache written in place.
    Returns ``(logits, cache)``.
    """
    del key
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    n_batch_shards = 1
    for a in axes:
        n_batch_shards *= mesh_axis_size(mesh, a)
    if batch % max(n_batch_shards, 1) != 0:
        axes = ()                      # e.g. long_500k batch=1: replicate
    b_spec = PartitionSpec(axes if axes else None)
    W = serve_cache_len(cfg, seq_len)
    cache_shape = init_cache(cfg, batch, W, dtype, device="meta")
    c_sh = cache_shardings(cfg, cache_shape, mesh)
    params_shape = init_params(cfg, 0, dtype, device="meta")
    psh = param_shardings(cfg, params_shape, mesh, stacked=False)
    b_places = placements(b_spec, mesh)

    def params_whole(params):
        if placed.tree_layouts([x for _, x in tree_paths(params)]) is None:
            params = place_tree(params, psh, mesh)
        return _whole(params)

    def rows_layout(shape):
        return placed.Layout.of(shape, mesh, b_places)

    def _prefill(params, tokens, prefix_embeds=None):
        whole = params_whole(params)
        lay = rows_layout((batch,) + tuple(tokens.shape[1:]))
        logits, cache = prefill(cfg, whole, _rows(tokens, lay),
                                _rows(prefix_embeds, lay), cache_len=W)
        del whole
        blocks = tree_map(_keep_block, cache["blocks"],
                          _layouts(c_sh["blocks"], cache_shape["blocks"],
                                   mesh))
        logits = rows_layout((batch,) + tuple(logits.shape[1:])).wrap(logits)
        return logits, {"pos": cache["pos"], "slot_pos": cache["slot_pos"],
                        "blocks": blocks}

    def _decode(params, token, cache):
        whole = params_whole(params)
        lay = rows_layout((batch,) + tuple(token.shape[1:]))
        blocks = cache["blocks"]
        if placed.tree_layouts([x for _, x in tree_paths(blocks)]) is None:
            blocks = place_tree(blocks, c_sh["blocks"], mesh)
        rows = tree_map(_gather_rows, blocks)
        logits, new = decode_step(cfg, whole, _rows(token, lay),
                                  {"pos": cache["pos"],
                                   "slot_pos": cache["slot_pos"],
                                   "blocks": rows})
        del whole
        moved = [(blk, row) for (_, blk), (_, row) in
                 zip(tree_paths(blocks), tree_paths(rows))
                 if row is not placed.local(blk)]
        if moved:                      # one host read, only when needed
            slot = int(cache["pos"]) % cache["slot_pos"].shape[0]
            for blk, row in moved:
                _write_back(blk, row, slot)
        logits = rows_layout((batch,) + tuple(logits.shape[1:])).wrap(logits)
        return logits, {"pos": new["pos"], "slot_pos": new["slot_pos"],
                        "blocks": blocks}

    return ServeFns(
        prefill=_prefill, decode=_decode,
        shardings={"params": psh, "cache": c_sh, "batch_spec": b_spec},
        cache_shape=cache_shape, params_shape=params_shape,
        batch_spec=b_spec)


def _layouts(specs, shapes, mesh):
    """The :class:`~repro_torch.carriers.placed.Layout` of each leaf of a
    cache tree on ``mesh`` by its spec."""
    return tree_map(lambda spec, t: placed.Layout.of(
        t.shape, mesh, placements(spec, mesh)), specs, shapes)


def _past_rows(lay: placed.Layout) -> list:
    """The dimensions of a cache leaf past its batch rows (dimension 1 of
    every stacked (L, B, ...) leaf)."""
    return [d for d in range(len(lay.shape)) if d != 1]


def _keep_block(rows: torch.Tensor, lay: placed.Layout):
    """The rank's rows of a cache leaf, computed whole past the rows ->
    the DTensor of its block (a copy, so the whole rows go with the
    caller's reference; the rows themselves where they are the block)."""
    idx = [slice(None)] * rows.dim()
    for d in _past_rows(lay):
        idx[d] = slice(*lay.block(d))
    whole = all(s == slice(None) or s == slice(0, n)
                for s, n in zip(idx, rows.shape))
    return lay.wrap(rows if whole else rows[tuple(idx)].clone())


def _gather_rows(x):
    """A cache leaf's block -> the rank's rows of it, whole past the rows
    (the block itself where nothing past the rows is split)."""
    return placed.gather(placed.local(x), placed.layout(x),
                         _past_rows(placed.layout(x)))


def _write_back(x, rows: torch.Tensor, slot: int) -> None:
    """After a decode step on ``rows`` (the rank's rows of a cache leaf,
    gathered whole past them), write the ring entry ``slot`` it wrote
    (dimension 2) into the leaf's block ``x``, where the block holds it.
    Only the ring leaves (K and V, MLA's latent and RoPE key) are split
    past the rows (``cache_shardings``); the others are gathered as
    their blocks themselves and written in place."""
    block, lay = placed.local(x), placed.layout(x)
    lo, hi = lay.block(2)
    if lo <= slot < hi:
        src = [slice(None)] * rows.dim()
        for d in _past_rows(lay):
            src[d] = slice(*lay.block(d))
        dst = [slice(None)] * rows.dim()
        src[2], dst[2] = slot, slot - lo
        block[tuple(dst)] = rows[tuple(src)]


# ---------------------------------------------------------------------------
# Slot-granular cache ops (continuous batching)
# ---------------------------------------------------------------------------

def slot_cache_insert(cache: dict, row: dict, slot: int,
                      true_len: int) -> dict:
    """Insert a batch-1 prefill cache ``row`` into ``slot`` of a per-slot
    cache (:func:`repro_torch.models.model.init_slot_cache` layout): every
    leaf of the block tree (K and V, or MLA's latent and RoPE key, and
    the recurrent states of the hybrid and xLSTM blocks), whole.

    ``true_len`` is the number of real prompt positions (prefix embeds
    included); ring entries holding positions ``>= true_len``, the prompt
    padding of a bucketed prefill, are marked empty, so padded keys are
    never attended to.
    """
    sp = row["slot_pos"]
    sp = torch.where((sp >= 0) & (sp < true_len), sp, -1)
    for (_, dst), (_, src) in zip(tree_paths(cache["blocks"]),
                                  tree_paths(row["blocks"])):
        dst[:, slot] = src[:, 0]
    cache["pos"][slot] = true_len
    cache["slot_pos"][slot] = sp
    return cache


def slot_cache_evict(cache: dict, slot: int) -> dict:
    """Clear one slot: empty ring (``slot_pos = -1``), position 0. Block
    contents stay: the empty ring makes them unreachable and the next
    :func:`slot_cache_insert` overwrites them. A recurrent state stays
    too, stale (the empty slot's ticks go on stepping it); the next
    insert overwrites it whole."""
    cache["pos"][slot] = 0
    cache["slot_pos"][slot] = -1
    return cache

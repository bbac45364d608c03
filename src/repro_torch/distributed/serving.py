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

Each rank computes its own rows of the batch on its blocks, one layer at
a time (``model.prefill`` and ``decode_step`` with the
:class:`~repro_torch.models.model.Parallel` of
:func:`~repro_torch.distributed.tensor_parallel.rank_parallel`, which the
tree trainer's step on a mesh builds too): how it uses each leaf is
:func:`~repro_torch.distributed.sharding.serve_use`'s rule. A "model"
split leaf is used where it lies when its block holds whole heads,
experts, ``d_ff`` columns or a vocabulary block: column-parallel
projections (GQA's and MLA's heads alike), row-parallel ``wo`` and
``w_down`` whose partial products are summed in rank order
(:func:`repro_torch.carriers.placed.rank_sum`, ``all_gather``s, so every
rank of a "model" group holds the same bits), expert blocks that run
every token and sum likewise, a vocabulary-parallel embedding (exact:
one rank adds a value that is not zero) and logits gathered along the
vocabulary. The other split leaves (a split through a head) are gathered
whole for their layer and let go before the next, as a layer split over
"data" (FSDP) is gathered from the rank that holds it. A rank so holds
its blocks, one layer's gathered leaves and its activations, never the
model whole. The decode cache stays in the rank's blocks: K and V split
on their heads are read and written in place; a ring split on W (and
MLA's latent, which every head reads) is gathered whole for its layer,
and the new entry written back into the block that holds it. No DTensor
operator runs. Where no mesh dimension of more than one rank splits a
leaf (a one-rank mesh, or rows alone) the route runs ``model.prefill``
and ``decode_step`` on the caller's tensors, bit for bit.

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
                                              placements, serve_uses)
from repro_torch.distributed.tensor_parallel import rank_parallel
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


def _split(spec, mesh) -> bool:
    """Whether a mesh dimension of more than one rank splits a leaf
    placed by ``spec``."""
    return any(mesh_axis_size(mesh, a) > 1 for e in spec if e is not None
               for a in (e if isinstance(e, tuple) else (e,)))


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
    rank runs ``model.prefill(..., cache_len=W)`` on its rows and its
    blocks (module docstring), keeping each layer's cache as its block
    of the cache specs as the layer ends; returns the logits placed on
    the batch spec and the cache on the cache specs (``pos`` and
    ``slot_pos`` plain, the same on every rank).

    ``decode(params, token, cache)``: ``token`` (B,) or (B, 1); a cache
    every rank holds whole is placed first. Each rank runs
    ``decode_step`` on its rows and blocks, its cache blocks written in
    place (a ring split on W gathered for its layer and the new entry
    written back): the counterpart of the reference's
    ``donate_argnums=(2,)``, the cache written in place.
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
    uses = serve_uses(cfg, params_shape, psh, mesh)
    on_blocks = mesh_axis_size(mesh, "model") > 1 or any(
        _split(spec, mesh) for _, spec in tree_paths(psh))

    def placed_tree(tree, specs):
        if placed.tree_layouts([x for _, x in tree_paths(tree)]) is None:
            tree = place_tree(tree, specs, mesh)
        return tree

    def rows_layout(shape):
        return placed.Layout.of(shape, mesh, b_places)

    def _parallel(params, c_lays, pos=None):
        return rank_parallel(cfg, mesh, tree_map(placed.local, params),
                             tree_map(placed.layout, params), uses,
                             c_lays=c_lays, pos=pos)

    def _prefill(params, tokens, prefix_embeds=None):
        params = placed_tree(params, psh)
        c_lays = _layouts(c_sh["blocks"], cache_shape["blocks"], mesh)
        par = _parallel(params, c_lays) if on_blocks else None
        lay = rows_layout((batch,) + tuple(tokens.shape[1:]))
        logits, cache = prefill(cfg, tree_map(placed.local, params),
                                _rows(tokens, lay), _rows(prefix_embeds, lay),
                                cache_len=W, par=par)
        blocks = tree_map(lambda t, lay: lay.wrap(t), cache["blocks"], c_lays)
        logits = rows_layout((batch,) + tuple(logits.shape[1:])).wrap(logits)
        return logits, {"pos": cache["pos"], "slot_pos": cache["slot_pos"],
                        "blocks": blocks}

    def _decode(params, token, cache):
        params = placed_tree(params, psh)
        blocks = placed_tree(cache["blocks"], c_sh["blocks"])
        c_lays = tree_map(placed.layout, blocks)
        par = _parallel(params, c_lays, cache["pos"]) if on_blocks \
            else None
        lay = rows_layout((batch,) + tuple(token.shape[1:]))
        logits, new = decode_step(cfg, tree_map(placed.local, params),
                                  _rows(token, lay),
                                  {"pos": cache["pos"],
                                   "slot_pos": cache["slot_pos"],
                                   "blocks": tree_map(placed.local, blocks)},
                                  par)
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

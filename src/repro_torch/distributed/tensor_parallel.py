"""A rank's :class:`~repro_torch.models.model.Parallel`: how one rank runs
the model's layers on its blocks, for serving
(:func:`repro_torch.distributed.serving.make_serve_fns`) and for the tree
trainer's step on a placed state
(:func:`repro_torch.distributed.fed_trainer.fed_train_step`).

How the rank uses each parameter leaf is
:func:`~repro_torch.distributed.sharding.serve_use`'s rule, the one rule
of both routes and of the dry run's reckoning: a "model"-split leaf whose
block holds whole heads, experts, ``d_ff`` columns or a vocabulary block
is used where it lies (column-parallel projections, GQA's and MLA's
heads alike, row-parallel ``wo`` and ``w_down`` whose partial products
are summed in rank order, expert blocks, a vocabulary-parallel embedding
and head), the other split leaves (a split through a head) are gathered
whole for their layer, and a layer split over "data"
(FSDP) is gathered from the rank that holds it. Every collective is
:mod:`repro_torch.carriers.placed`'s, so autograd goes through each: a
training pass runs its backward on the same blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

from repro_torch.carriers import placed
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.distributed.sharding import mesh_axis_size
from repro_torch.models.attention import kv_heads_for
from repro_torch.models.model import Parallel


def rank_parallel(cfg: ModelConfig, mesh, params, lays, uses, *,
                  rows: Sequence[int] = (), c_lays=None,
                  pos=None) -> Parallel:
    """This rank's :class:`~repro_torch.models.model.Parallel` for one
    call: ``params`` the rank's blocks (plain tensors), ``lays`` their
    :class:`~repro_torch.carriers.placed.Layout` tree (one model's
    leaves: no agent dimension), ``uses`` their :func:`~repro_torch.
    distributed.sharding.serve_use` tree; ``rows`` the mesh dimensions
    that split the call's batch rows (a layer split over one of them
    brings the ranks' partial gradients to its holder, summed). Serving
    gives ``c_lays``, the cache blocks' layouts, and, for a decode, the
    cache's ``pos`` (read on the host only where a ring split on W takes
    the new entry); a training pass has no cache (``keep`` and ``cache``
    None)."""
    names = tuple(mesh.mesh_dim_names)
    mdim = names.index("model") if "model" in names else None
    m = mesh_axis_size(mesh, "model")
    c = 0 if mdim is None else mesh.get_coordinate()[mdim]
    group = [] if mdim is None else [mdim]
    blk = uses["blocks"]
    a_use, f_use = blk.get("attn", {}), blk.get("mlp", {})

    def psum(t):
        return placed.rank_sum(t, mesh, group)

    def enter(t):
        return placed.enter(t, mesh, group)

    def pmax(t):
        return placed.rank_max(t, mesh, group)

    def layer(i):
        def one(t, lay, use):
            t, lay = placed.layer_block(t, lay, i, rows)
            return placed.gather(t, lay, range(t.dim())) if use == "gather" \
                else t
        return tree_map(one, params["blocks"], lays["blocks"], blk)

    def gather_vocab(t):
        lay = placed.Layout(mesh, tuple(t.shape[:-1]) + (cfg.vocab_size,),
                            ((),) * (t.dim() - 1) + ((mdim,),))
        return placed.gather(t, lay, [t.dim() - 1])

    kv_block = a_use.get("wk") == "cols"
    kw = {}
    hb = cfg.n_heads // m
    if cfg.mla is not None:
        # MLA reads its dims from cfg.mla, and each head its own K and V
        if a_use.get("w_uk") == "cols":
            kw["attn_cfg"] = dataclasses.replace(cfg, n_heads=hb,
                                                 n_kv_heads=hb)
    elif a_use.get("wq") == "cols":
        kw["attn_cfg"] = dataclasses.replace(
            cfg, n_heads=hb, head_dim=cfg.resolved_head_dim,
            n_kv_heads=cfg.n_kv_heads // m if kv_block else cfg.n_kv_heads)
        if not kv_block:
            kw["kv_heads"] = kv_heads_for(cfg, c * hb, (c + 1) * hb)
    if f_use.get("w_down") == "experts":
        eb = cfg.moe.n_experts // m
        kw["experts"] = (c * eb, (c + 1) * eb)
    if uses["embed"] == "vocab":       # and lm_head "cols": the same V
        vb = cfg.vocab_size // m
        kw.update(vocab=(c * vb, (c + 1) * vb), gather_vocab=gather_vocab)
    if c_lays is not None:
        kw.update(_cache_fns(c_lays, kv_block, pos))
    return Parallel(
        layer=layer, psum=psum, enter=enter, pmax=pmax,
        attn_cfg=kw.pop("attn_cfg", cfg),
        attn_partial=a_use.get("wo") == "rows",
        mlp_partial=f_use.get("w_down") in ("rows", "experts"),
        shared_partial=f_use.get("shared", {}).get("w_down") == "rows",
        **kw)


def _cache_fns(c_lays, kv_block: bool, pos: Optional[object]) -> dict:
    """Serving's ``keep`` and ``cache`` of a rank's
    :class:`~repro_torch.models.model.Parallel`."""

    def whole_dims(one: placed.Layout) -> list:
        # the dimensions of a layer's cache leaf that the layer computes
        # whole though they are split: the ring W, and K's and V's heads
        # where the layer runs every KV head
        return [d for d in (1, 2) if d < len(one.shape) and one.parts(d) > 1
                and not (d == 2 and kv_block)]

    def keep(i, parts):
        def cut(t, lay):
            one = lay.without_first()
            dims = whole_dims(one)
            if not dims:
                return t
            idx = [slice(None)] * t.dim()
            for d in dims:
                idx[d] = slice(*one.block(d))
            return t[tuple(idx)].clone()
        return tree_map(cut, parts, c_lays)

    slot = []                          # pos % W, read once, when needed

    @contextlib.contextmanager
    def cache(i, blocks):
        # such a leaf is gathered for the layer and the new ring entry
        # written back into the block; the others are read and written
        # in place
        moved = []

        def rows(t, lay):
            view, one = t[i], lay.without_first()
            dims = whole_dims(one)
            if not dims:
                return view
            whole = placed.gather(view, one, dims)
            moved.append((view, whole, one, dims))
            return whole
        yield tree_map(rows, blocks, c_lays)
        for view, whole, one, dims in moved:
            if not slot:
                slot.append(int(pos) % whole.shape[1])
            lo, hi = one.block(1)
            if lo <= slot[0] < hi:
                idx = [slice(None)] * whole.dim()
                for d in dims:
                    idx[d] = slice(*one.block(d))
                idx[1] = slot[0]
                view[:, slot[0] - lo] = whole[tuple(idx)]

    return {"keep": keep, "cache": cache}

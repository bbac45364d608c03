"""Robust aggregation, GDA agreement and Byzantine attacks on
agent-stacked parameter trees: the port of the JAX package's
``distributed/aggregation.py`` (its one-process part).

A stacked tree is a nested dict (or a bare tensor) whose every leaf
carries the K agents on its leading axis. Distances come from the (K, K)
Gram matrix, summed leaf by leaf over each leaf's trailing axes, so no
leaf is ever concatenated with another; the only O(K·d) products are the
weighted sums and GDA's mixing. The reference computes all of this in
plain ``jnp`` outside its Pallas kernels, and so does the port: plain
PyTorch, float32 with TF32 off (``repro_torch/__init__.py``).

Leaves are visited in ``jax.tree_util``'s order (dict keys sorted,
:func:`repro_torch.core.tree.tree_paths`), so the normals of
``large_noise`` land on the same coordinates as the reference's. Those
normals arrive as one explicit tensor, (n_byz, D) over the raveled tree
(the Byzantine rows only), drawn by :func:`repro_torch.core.noise.
draw_fed_noise`.

The ``fed_aggregator`` namespace holds the tree aggregators ``mean``,
``krum``, ``rfa(n_iter, nu)`` and ``trimmed_mean``; ``fed_attack`` holds
``none``, ``large_noise(sigma)``, ``avg_zero`` and ``sign_flip(scale)``.

The D-sharded flat layer (``dim_sharded``, ``flat_*``) takes a (K, D)
stack, plain or split along D over a mesh's ranks (the carrier of
:mod:`repro_torch.carriers.columns`, the reference's ``P(None,
"model")``), and runs the registry aggregators' bodies
(:mod:`repro_torch.core.aggregators`) on it: the kernels on each rank's
columns, the (K, K) Gram partials summed over the ranks in rank order. A
plain tensor is the route with one shard: no collective, the
one-process kernels' bits. ``stacked_gram``, ``stacked_sq_dists``,
``stacked_weighted_sum``, ``stacked_mix``, ``gda_agree`` and
``attack_stacked`` take a D-sharded bare stack the same way, so the flat
trainer's sharded step runs on them.

A tree of placed leaves (:mod:`repro_torch.carriers.placed`: K over
the federation dimensions, trailing dimensions over "model" and the
layer stack over "data" by :func:`repro_torch.distributed.sharding.
param_spec`; the tree trainer under a mesh) takes the same functions:
what needs all K agents (a Gram partial, GDA's mix, a weighted sum, the
coordinate-wise mean and trimmed mean, the attacks' honest sums) gathers
the K rows of the rank's block over the federation dimensions; the
leaves' Gram partials are summed into one (K, K) matrix before one sum
over the dimensions that split them; ``large_noise`` takes the rank's
rows and block of its normals. On a one-rank mesh each is the plain
tree's operation, bit for bit.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core import aggregators
from repro_torch.core.registry import register, resolve
from repro_torch.core.tree import tree_map, tree_paths
# dim_sharded is the carrier's; the reference's flat layer exports it here
from repro_torch.carriers.columns import dim_sharded  # noqa: F401
from repro_torch.carriers.columns import local_columns, on_columns
from repro_torch.carriers import placed
from repro_torch.kernels.pairwise_dist import sq_dists_from_gram


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def _rows(leaf: torch.Tensor) -> torch.Tensor:
    """(K, ...) -> (K, n): each agent's entries of the leaf, as a view
    where the leaf is contiguous."""
    return leaf.reshape(leaf.shape[0], -1)


def _layouts(tree) -> Optional[list]:
    """The layouts of a placed tree's leaves; None for a plain tree."""
    return placed.tree_layouts(_leaves(tree))


def _placement(tree):
    """``(blocks, layouts, dims)``: each leaf's block (a plain leaf
    itself), its layout (None for a plain leaf) and the mesh dimensions
    that split a leaf's trailing dimensions (none for a plain tree), over
    which the leaves' partials are summed."""
    leaves = _leaves(tree)
    lays = _layouts(tree)
    if lays is None:
        return leaves, [None] * len(leaves), []
    dims = sorted({m for lay in lays for m in lay.trailing})
    return [placed.local(x) for x in leaves], lays, dims


def _summed(partial: torch.Tensor, lay, dims) -> torch.Tensor:
    """A sum of leaf partials over a rank's blocks -> the tree's: summed
    in rank order over ``dims`` (as is for a plain tree)."""
    return partial if lay is None else placed.rank_sum(partial, lay.mesh,
                                                       dims)


def _per_leaf(fn, tree):
    """``fn(x, lay)`` leaf by leaf: a plain leaf with ``lay`` None, or a
    placed leaf's block with its :class:`~repro_torch.carriers.placed.
    Layout` (``fn`` wraps its result)."""
    lays = _layouts(tree)
    if lays is None:
        return tree_map(lambda leaf: fn(leaf, None), tree)
    it = iter(lays)
    return tree_map(lambda leaf: fn(placed.local(leaf), next(it)), tree)


def _all_rows(x: torch.Tensor, lay) -> torch.Tensor:
    """A leaf's K rows: the plain leaf, or a placed block's rows gathered
    over the federation dimensions (its trailing block kept)."""
    return x if lay is None else placed.gather(x, lay, [0])


def _own_rows(t: torch.Tensor, lay) -> torch.Tensor:
    """The rank's rows of a (K, ...) tensor; all of it for a plain leaf."""
    return t if lay is None else t[slice(*lay.block(0))]


# ---------------------------------------------------------------------------
# Stacked-tree linear algebra
# ---------------------------------------------------------------------------

def stacked_gram(tree) -> torch.Tensor:
    """Stacked tree -> (K, K) Gram matrix, f32: each leaf contracted over
    its trailing axes, the leaves' products summed in leaf order. A
    D-sharded stack: the local columns' matrix, summed over the ranks."""
    return stacked_gram_blocked(tree, 0)


def stacked_gram_blocked(tree, block: int) -> torch.Tensor:
    """The Gram matrix in column blocks of ``block`` agents (the plain
    form when ``block <= 0``, ``K <= block`` or ``block`` does not divide
    K): block i's columns sum the leaves' products with agents
    ``[i·block, (i+1)·block)``. A D-sharded stack: the local columns'
    matrix, summed over the ranks.

    A placed tree: each leaf's rows gathered once over the federation
    dimensions, its partials over the rank's block added in leaf order,
    then one sum in rank order over every mesh dimension that splits a
    leaf's trailing dimensions (a leaf whole along one of those counts on
    one rank there, ``placed.owns``)."""
    local, sh = local_columns(tree)
    if sh is not None:
        return sh.sum(stacked_gram_blocked(local, block))
    blocks, lays, dims = _placement(tree)
    K = blocks[0].shape[0] if lays[0] is None else lays[0].shape[0]
    n = K // block if 0 < block < K and not K % block else 1
    w = K // n
    cols = [torch.zeros((K, w), dtype=torch.float32, device=blocks[0].device)
            for _ in range(n)]
    for x, lay in zip(blocks, lays):
        if placed.owns(lay, dims):
            r = _rows(_all_rows(x, lay)).float()
            for i in range(n):
                cols[i] = cols[i] + r @ r[i * w:(i + 1) * w].T
    g = cols[0] if n == 1 else torch.cat(cols, dim=1)
    # a host BLAS may sum G_ij and G_ji in different orders (an AMD EPYC
    # host's did, an ulp apart): the upper triangle mirrored keeps G, and
    # Krum's ties between the two agents of a pair, symmetric, as the
    # reference's are
    g = torch.triu(g) + torch.triu(g, 1).T
    return _summed(g, lays[0], dims)


def stacked_sq_dists(tree) -> torch.Tensor:
    """(K, K) squared distances between the agents, from the Gram
    matrix, clamped at 0."""
    return sq_dists_from_gram(stacked_gram(tree))


def stacked_sq_norms(tree) -> torch.Tensor:
    """(K,) squared norms of the agents' rows over the tree's leaves. A
    placed tree: the rank's agents' partials over their blocks summed
    like :func:`stacked_gram_blocked`'s, then gathered over the
    federation dimensions."""
    blocks, lays, dims = _placement(tree)
    sq = torch.zeros(blocks[0].shape[:1], dtype=blocks[0].dtype,
                     device=blocks[0].device)
    for x, lay in zip(blocks, lays):
        if placed.owns(lay, dims):
            sq = sq + torch.sum(_rows(x) ** 2, dim=1)
    sq = _summed(sq, lays[0], dims)
    return sq if lays[0] is None else lays[0].agents(sq)


def stacked_weighted_sum(w: torch.Tensor, tree, mix_dtype=None):
    """Per leaf ``Σ_k w_k leaf_k``, in f32 (the leaf rounded to
    ``mix_dtype`` first when given), cast back to the leaf's dtype; a
    D-sharded stack's sum keeps its columns."""
    local, sh = local_columns(tree)
    if sh is not None:
        return sh.wrap(stacked_weighted_sum(w, local, mix_dtype))
    wf = w.float()

    def f(rows):
        lc = rows if mix_dtype is None else rows.to(mix_dtype)
        out = wf @ _rows(lc).float()
        return out.reshape(rows.shape[1:]).to(rows.dtype)

    return _over_agents(f, tree)


def _over_agents(fn, tree):
    """``fn`` on each leaf's K rows -> one agent's leaf; a placed leaf's
    result is its block, placed as the agent's leaf (replicated over the
    federation dimensions)."""
    def f(x, lay):
        out = fn(_all_rows(x, lay))
        return out if lay is None else lay.without_first().wrap(out)
    return _per_leaf(f, tree)


def _mix_leaf(W: torch.Tensor, leaf: torch.Tensor, mix_dtype
              ) -> torch.Tensor:
    """``einsum("kl,l...->k...", W, leaf)`` accumulated in f32, before the
    cast back. With ``mix_dtype`` both operands are rounded to it and
    multiplied in f32: the reference's bf16 operands with an f32
    accumulator (a bf16 matmul would round the sum as well)."""
    if mix_dtype is None:
        out = W.to(leaf.dtype) @ _rows(leaf)
    else:
        out = W.to(mix_dtype).float() @ _rows(leaf).to(mix_dtype).float()
    return out.float().reshape((W.shape[0],) + leaf.shape[1:])


def stacked_mix(W: torch.Tensor, tree, mix_dtype=None, block: int = 0):
    """Row-stochastic mixing ``leaf'_k = Σ_l W[k, l] leaf_l``: the O(K·d)
    exchange of Avg-Agree. ``mix_dtype=torch.bfloat16`` mixes bf16
    messages; ``block > 0`` sums the exchange over column blocks of
    ``block`` agents in block order (the plain form when ``K <= block``
    or ``block`` does not divide K). A D-sharded stack mixes its local
    columns."""
    local, sh = local_columns(tree)
    if sh is not None:
        return sh.wrap(stacked_mix(W, local, mix_dtype, block))
    K = _leaves(tree)[0].shape[0]
    blocked = not (block <= 0 or K <= block or K % block)

    def f(x, lay):
        rows, Wr = _all_rows(x, lay), _own_rows(W, lay)
        if not blocked:
            out = _mix_leaf(Wr, rows, mix_dtype).to(x.dtype)
        else:
            acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for i in range(K // block):
                cols = slice(i * block, (i + 1) * block)
                acc = acc + _mix_leaf(Wr[:, cols], rows[cols], mix_dtype)
            out = acc.to(x.dtype)
        return out if lay is None else lay.wrap(out)

    return _per_leaf(f, tree)


def _broadcast_rows(tree_single, K: int, like=None):
    """One agent's tree -> the stacked tree with it in every row, as
    expanded views (the reference's ``broadcast_to``); placed like the
    stacked tree ``like`` when that is placed (the rank's rows of it)."""
    lays = None if like is None else _layouts(like)
    if lays is None:
        return tree_map(lambda leaf: leaf[None].expand((K,) + leaf.shape),
                        tree_single)
    it = iter(lays)

    def f(leaf):
        lay, x = next(it), placed.local(leaf)
        lo, hi = lay.block(0)
        return lay.wrap(x[None].expand((hi - lo,) + x.shape))

    return tree_map(f, tree_single)


# ---------------------------------------------------------------------------
# The D-sharded flat (K, D) execution layer
# ---------------------------------------------------------------------------
# Each function takes a (K, D) stack or a batch of them (Bt, K, D),
# D-sharded or plain (one shard), and runs the registry aggregator's body
# on it: the Gram matrix is the local partial summed over the ranks, the
# weights and scores come from that one (K, K) matrix on every rank, and
# the weighted sums, row picks and coordinate-wise reduces stay local.
# ``block > 0`` makes the local partial from plain products in column
# blocks of ``block`` agents (:func:`stacked_gram_blocked`, as the
# reference's blocked route). Results keep D's placement.

def _flat(fn, x):
    """``fn`` on the (Bt, K, D) form of ``x``; a (K, D) stack's (1, ...)
    result comes back without its leading axis."""
    if x.dim() == 3:
        return fn(x)
    return on_columns(lambda t: t[0], fn(on_columns(lambda t: t[None], x)))


def _gram_of(block: int):
    """The combined Gram matrices of the flat layer's ``block``."""
    if not block:
        return aggregators.combined_gram

    def blocked(x, sh):
        g = torch.stack([stacked_gram_blocked(m, block) for m in x])
        return g if sh is None else sh.sum(g)
    return blocked


def flat_gram(x, block: int = 0) -> torch.Tensor:
    """(K, D) or (Bt, K, D) -> the (K, K) or (Bt, K, K) Gram matrix, the
    same on every rank."""
    local, sh = local_columns(x)
    g = _gram_of(block)(local if local.dim() == 3 else local[None], sh)
    return g if local.dim() == 3 else g[0]


def flat_sq_dists(x, block: int = 0) -> torch.Tensor:
    """(K, D) -> (K, K) squared distances from :func:`flat_gram`."""
    return sq_dists_from_gram(flat_gram(x, block))


def flat_krum(x, n_byz: int, m: int = 1, block: int = 0):
    """(Multi-)Krum (:func:`repro_torch.core.aggregators.krum`): the
    winner's columns by index, or the mean of the m best rows."""
    return _flat(lambda t: aggregators.krum(t, n_byz, m,
                                            gram_of=_gram_of(block)), x)


def flat_rfa(x, n_iter: int = 32, nu: float = 1e-6, block: int = 0):
    """Smoothed Weiszfeld (:func:`repro_torch.core.aggregators.rfa`):
    weights from the combined Gram matrix, the same on every rank, then
    ``wsum`` on the local columns."""
    return _flat(lambda t: aggregators.rfa(t, n_iter, nu,
                                           gram_of=_gram_of(block)), x)


def flat_trimmed_mean(x, n_trim: int):
    """The coordinate-wise trimmed mean
    (:func:`repro_torch.core.aggregators.trimmed_mean`), the one-process
    bits whatever the split."""
    return _flat(lambda t: aggregators.trimmed_mean(t, n_trim), x)


# ---------------------------------------------------------------------------
# Robust aggregators on stacked trees (broadcast-consistent adversary)
# ---------------------------------------------------------------------------

def agg_mean(tree, n_byz: int = 0):
    K = _leaves(tree)[0].shape[0]
    return _broadcast_rows(_over_agents(lambda rows: rows.mean(0), tree), K,
                           tree)


def agg_krum(tree, n_byz: int):
    """Krum: the agent whose ``max(K − n_byz − 2, 1)`` nearest others are
    closest in sum (the first on ties), in every row."""
    K = _leaves(tree)[0].shape[0]
    d2 = stacked_sq_dists(tree)
    n_near = max(K - n_byz - 2, 1)
    near = torch.sort(d2, dim=1).values[:, 1:n_near + 1]
    winner = torch.argmin(near.sum(1))
    sel = torch.nn.functional.one_hot(winner, K).float()
    return _broadcast_rows(stacked_weighted_sum(sel, tree), K, tree)


def agg_rfa(tree, n_byz: int = 0, n_iter: int = 8, nu: float = 1e-6):
    """Smoothed Weiszfeld in weight space: ``n_iter`` steps from w = 1/K
    on the Gram matrix, ‖x_k − z‖² = G_kk − 2 (G w)_k + wᵀ G w, then one
    weighted sum, in every row."""
    K = _leaves(tree)[0].shape[0]
    g = stacked_gram(tree)
    sq = torch.diagonal(g)
    w = torch.full((K,), 1.0 / K, dtype=torch.float32, device=g.device)
    for _ in range(n_iter):
        dz = torch.sqrt(torch.clamp_min(sq - 2.0 * g @ w + w @ g @ w, 0.0)
                        + nu)
        w = (1.0 / dz) / torch.sum(1.0 / dz)
    return _broadcast_rows(stacked_weighted_sum(w, tree), K, tree)


def agg_trimmed_mean(tree, n_byz: int):
    """Coordinate-wise: the mean of ranks ``[n, K − n)`` with ``n =
    min(n_byz, (K − 1) // 2)``; the mean when n is 0."""
    K = _leaves(tree)[0].shape[0]
    n = min(n_byz, (K - 1) // 2)
    if n == 0:
        return agg_mean(tree)

    def f(rows):
        s = torch.sort(rows.float(), dim=0).values[n:K - n]
        return s.mean(0).to(rows.dtype)

    return _broadcast_rows(_over_agents(f, tree), K, tree)


register("fed_aggregator", "mean")(lambda: agg_mean)
register("fed_aggregator", "krum")(lambda: agg_krum)
register("fed_aggregator", "trimmed_mean")(lambda: agg_trimmed_mean)


@register("fed_aggregator", "rfa", static_kwargs=("n_iter", "nu"))
def _fed_rfa_factory(n_iter: int = 8, nu: float = 1e-6):
    return functools.partial(agg_rfa, n_iter=n_iter, nu=nu)


def aggregate(name, tree, n_byz: int):
    """Resolve a stacked-tree aggregator spec (name, spec string such as
    ``"rfa(n_iter=16)"``, or Spec) and apply it."""
    return resolve("fed_aggregator", name)(tree, n_byz=n_byz)


# ---------------------------------------------------------------------------
# GDA averaging agreement on stacked trees
# ---------------------------------------------------------------------------

def gda_mix_matrix(d2: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Per-agent greedy selection: W[k, l] = 1/n_keep for the n_keep
    agents closest to agent k (self included, d2[k, k] = 0). Ties keep
    the lower index, as ``lax.top_k`` does: a stable ascending sort."""
    K = d2.shape[0]
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :n_keep]
    W = torch.zeros((K, K), dtype=torch.float32, device=d2.device)
    return W.scatter_(1, idx, 1.0 / n_keep)


def gda_agree(tree, kappa: int, alpha_bar: float = 0.2,
              mix_dtype: Optional[torch.dtype] = None, block: int = 0):
    """κ rounds of GDA averaging agreement on a stacked tree: each round
    mixes every agent with its ``max(⌈(1 − alpha_bar)·K⌉, 1)`` nearest
    (the reference's ``int(… + 0.999)``)."""
    K = _leaves(tree)[0].shape[0]
    if K == 1 or kappa == 0:
        return tree
    n_keep = max(int((1.0 - alpha_bar) * K + 0.999), 1)
    for _ in range(kappa):
        g = stacked_gram_blocked(tree, block) if block \
            else stacked_gram(tree)
        W = gda_mix_matrix(sq_dists_from_gram(g), n_keep)
        tree = stacked_mix(W, tree, mix_dtype=mix_dtype, block=block)
    return tree


# ---------------------------------------------------------------------------
# Stacked-tree Byzantine attacks
# ---------------------------------------------------------------------------
# An attack is fn(tree, byz_mask (K,) bool, noise) -> tree. ``noise`` is
# the (n_byz, D) standard normals of the Byzantine rows over the raveled
# tree, for an attack registered with ``noise=True``; the others take None.
# A placed tree is attacked on the rank's rows and blocks: its normals are
# the whole draw (every rank draws the same) and each rank picks its own.

def _byz_to(byz_mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return byz_mask.reshape(byz_mask.shape + (1,) * (leaf.dim() - 1))


@register("fed_attack", "none")
def _fed_none_factory():
    return lambda tree, byz_mask, noise=None: tree


@register("fed_attack", "large_noise", noise=True,
          static_kwargs=("sigma",))
def _fed_large_noise_factory(sigma: float = 100.0):
    def fn(tree, byz_mask, noise):
        if noise is None:
            raise ValueError("large_noise needs its noise tensor")
        off = 0

        def f(x, lay):
            nonlocal off
            shape = x.shape if lay is None else lay.shape
            n = math.prod(shape[1:])
            src = (sigma * noise[:, off:off + n]).reshape((-1,) + shape[1:])
            off += n
            mask = _own_rows(byz_mask, lay)
            if lay is not None:
                # noise row j is the j-th Byzantine agent in K order
                if lay.trailing:
                    src = src[(slice(None),) + lay.index(1)]
                if mask.shape[0] != byz_mask.shape[0]:
                    nth = torch.cumsum(byz_mask.long(), 0) - 1
                    src = src[_own_rows(nth, lay)[mask]]
            out = x.clone()
            out[mask] = src
            return out if lay is None else lay.wrap(out)

        out = _per_leaf(f, tree)
        if off != noise.shape[1]:
            raise ValueError(f"large_noise: noise has {noise.shape[1]} "
                             f"columns, the tree {off}")
        return out
    return fn


@register("fed_attack", "avg_zero")
def _fed_avg_zero_factory():
    def fn(tree, byz_mask, noise=None):
        n_byz = torch.clamp_min(byz_mask.sum(), 1)

        def f(x, lay):
            rows = _all_rows(x, lay)
            hsum = torch.where(_byz_to(byz_mask, rows), 0.0, rows).sum(0)
            m = _byz_to(_own_rows(byz_mask, lay), x)
            out = torch.where(m, (-hsum / n_byz)[None], x)
            return out if lay is None else lay.wrap(out)
        return _per_leaf(f, tree)
    return fn


@register("fed_attack", "sign_flip", static_kwargs=("scale",))
def _fed_sign_flip_factory(scale: float = 3.0):
    def fn(tree, byz_mask, noise=None):
        n_h = torch.clamp_min((~byz_mask).sum(), 1)

        def f(x, lay):
            rows = _all_rows(x, lay)
            mu = torch.where(_byz_to(byz_mask, rows), 0.0, rows).sum(0) / n_h
            m = _byz_to(_own_rows(byz_mask, lay), x)
            out = torch.where(m, (-scale * mu)[None], x)
            return out if lay is None else lay.wrap(out)
        return _per_leaf(f, tree)
    return fn


def attack_stacked(name, tree, byz_mask, noise=None):
    """Resolve a stacked-tree attack spec (name, spec string such as
    ``"large_noise(sigma=10)"``, or Spec) and apply it; ``None`` returns
    the tree. A D-sharded stack is attacked on its local columns, with
    those columns of ``noise``."""
    if name is None:
        return tree
    local, sh = local_columns(tree)
    if sh is not None:
        cols = None if noise is None else noise[:, sh.lo:sh.hi]
        return sh.wrap(attack_stacked(name, local, byz_mask, cols))
    return resolve("fed_attack", name)(tree, byz_mask, noise)

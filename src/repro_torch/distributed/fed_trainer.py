"""Federated DecByzPG trainer for the model architectures: the port of
the JAX package's ``distributed/fed_trainer.py`` (its one-process part).

Every agent's parameters and optimizer state carry a leading K axis. Per
step (the PAGE coin picks one of two branches on the host):

  large (c=1): ṽ^(k) = ∇CE(θ^(k); batch_k)
  small (c=0): ṽ^(k) = ∇CE(θ^(k); b_k) − ∇CE(θ_prev^(k); b_k) + v_prev^(k)

then: attack → robust aggregate → per-agent optimizer step → GDA
agreement (κ rounds). Two trainers share the protocol:

* the tree trainer (:func:`fed_train_step`, :func:`fed_train_window`)
  keeps the model's nested parameter dict with K-stacked leaves and
  aggregates with the ``fed_aggregator`` rules of
  :mod:`repro_torch.distributed.aggregation` (plain PyTorch, as in the
  reference);
* the flat trainer (:func:`fed_train_step_flat`) ravels each agent's
  parameters into one row of a (K, D) stack and aggregates with the
  *registry* aggregators (:mod:`repro_torch.core.aggregators`), which run
  the CUDA kernels: RFA ``gram`` → ``weiszfeld`` → ``wsum``, Krum
  ``gram`` → ``krum_score``, the trimmed mean ``trimmed_mean``.

The reference's ``jax.vmap`` over the agents is a loop here: each agent's
loss and gradient run on views of its row of the stacks (the chunked
attention route, as every training pass does). The PAGE combination and
the optimizer update also run agent by agent, so the temporaries at full
width are one agent's, not K's; both are elementwise, so the bits are
the stacked form's. A step never writes into the state it is given.

Randomness: a step takes a :class:`~repro_torch.core.noise.FedNoise`
(the attack's normals, the bucketing permutation) in place of the
reference's key; the window draws its coins and every step's noise from
one ``torch.Generator``. ``common_sample_coin`` is the reference's numpy
coin, bit for bit. The phases are ``torch.profiler`` ranges
(``fed.estimate``, ``fed.aggregate``, ``fed.agree``) when
``fed.telemetry`` is on.

Under a mesh, the flat trainer splits its (K, D) stacks along D over the
"model" ranks (:func:`flat_param_sharding`, DTensors, the reference's
``P(None, "model")``), and ``fed_train_step_flat`` runs each rank's
columns through the D-sharded flat layer of
:mod:`repro_torch.distributed.aggregation`: the Gram partials and the
estimate's rows gathered in rank order, the rest local.

The tree trainer under a mesh places every leaf of its state by the
reference's rules (:func:`fed_state_shardings`, :func:`place_fed_state`:
K over the federation dimensions, trailing dimensions over "model", a
layer stack over "data" with ``fsdp_layers``; DTensors of
:mod:`repro_torch.carriers.placed`). ``fed_train_step`` on such a
state runs the rank's own agents only: each agent's loss and gradient on
the rank's rows and blocks (:func:`_estimate_blocks`: the rank's
:class:`~repro_torch.models.model.Parallel` of
:mod:`repro_torch.distributed.tensor_parallel`, autograd through every
rank-order sum and gather, one layer's leaves gathered at a time where
they must be, never an agent's whole leaves, its directions or its
logits), the gradient coming out at the rank's block; the aggregation
and agreement on the placed tree; Adam on the blocks. Where no mesh
dimension of more than one rank splits an agent's leaves or rows
(``fed_axis="all"``) each agent's loss is the plain one.
:func:`make_fed_step` gives the step, its state and batch shapes (on
the ``meta`` device) and their specs. On a one-rank mesh the step is the
plain step, bit for bit and byte for byte.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.aggregators import rejection_mask
from repro_torch.core.noise import FedNoise, draw_fed_coins, draw_fed_noise
from repro_torch.core.registry import normalize_spec_fields, resolve
from repro_torch.core.tree import (ravel_tree, tree_map, tree_paths,
                                   unravel_tree)
from repro_torch.distributed import aggregation as agg_lib
from repro_torch.carriers import columns, placed
from repro_torch.distributed.sharding import (PartitionSpec, batch_axes,
                                              batch_spec, mesh_axis_size,
                                              n_agents, param_shardings,
                                              place_tree, placements,
                                              serve_uses)
from repro_torch.distributed.tensor_parallel import rank_parallel
from repro_torch.models.model import (init_params, lm_loss, lm_loss_labeled,
                                      param_shapes)
from repro_torch.optim.optimizers import get_optimizer


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """The reference's config: the same fields and defaults."""
    aggregator: object = "rfa"       # str | Spec, normalized to Spec
    kappa: int = 4
    alpha_bar: float = 0.2
    n_byz: int = 0
    attack: object = "none"
    lr: float = 1e-4
    optimizer: object = "adam"
    page_p: float = 0.1              # Common-Sample coin probability
    mix_dtype: Optional[str] = None  # None | "bfloat16"
    mix_block: int = 0               # agreement in K-blocks
    seed: int = 0
    telemetry: bool = False          # taps + profiler phases

    def __post_init__(self):
        normalize_spec_fields(self, ("aggregator", "attack", "optimizer"))


class FedState(NamedTuple):
    params: object       # agent-stacked (K, ...) leaves
    prev_params: object
    v: object            # running PAGE direction, agent-stacked
    opt_state: object
    step: torch.Tensor   # () int32


class FlatFedState(NamedTuple):
    theta: torch.Tensor  # (K, D) flat agent-stacked parameters
    prev: torch.Tensor
    v: torch.Tensor      # running PAGE direction, (K, D)
    opt_state: object
    step: torch.Tensor


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def _unflat(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def _stack_rows(leaf: torch.Tensor, K: int) -> torch.Tensor:
    """K materialised copies of one agent's leaf."""
    return leaf[None].repeat((K,) + (1,) * leaf.dim())


def _zero_rows(leaf: torch.Tensor) -> torch.Tensor:
    """A zero direction shaped like the stacked leaf: one zero row,
    expanded over the agents (every row of v is the broadcast aggregate
    after the first step)."""
    return torch.zeros_like(leaf[0])[None].expand(leaf.shape)


# ---------------------------------------------------------------------------
# The optimizer on stacked trees, one agent at a time
# ---------------------------------------------------------------------------

def _is_moment(field, leaves) -> bool:
    """A state field with one tensor per parameter leaf (Adam's m and v);
    the others are per-agent counters (Adam's step)."""
    fl = _leaves(field)
    return len(fl) == len(leaves) and all(
        a.shape == b.shape for a, b in zip(fl, leaves))


def tree_opt_init(opt, params):
    """The optimizer state of a stacked tree, as the reference's
    ``vmap(opt.init)``: moments leaf by leaf, one (K,) counter."""
    leaves = _leaves(params)
    per = [opt.init(_rows(leaf)) for leaf in leaves]
    fields = []
    for i, f0 in enumerate(per[0]):
        if f0.shape == _rows(leaves[0]).shape:
            fields.append(_unflat(params, [s[i].reshape(leaf.shape)
                                           for s, leaf in zip(per, leaves)]))
        else:
            fields.append(f0)
    return type(per[0])(*fields)


def _update_rows(opt, g, s, p, moment):
    """``opt.update`` on one (K, ...) leaf, agent by agent: each row as a
    (1, n) stack with its counters' row. Every operation is elementwise,
    so the result is the stacked update's, bit for bit."""
    K = p.shape[0]
    new_p = torch.empty_like(p)
    fields = [torch.empty_like(p, dtype=f.dtype) if m else []
              for f, m in zip(s, moment)]
    for k in range(K):
        r = slice(k, k + 1)
        s_k = type(s)(*(_rows(f[r]) if m else f[r]
                        for f, m in zip(s, moment)))
        p_k, n_k = opt.update(_rows(g[r]), s_k, _rows(p[r]))
        new_p[r] = p_k.reshape(new_p[r].shape)
        for j, m in enumerate(moment):
            if m:
                fields[j][r] = n_k[j].reshape(fields[j][r].shape)
            else:
                fields[j].append(n_k[j])
    return new_p, type(s)(*(f if m else torch.cat(f)
                            for f, m in zip(fields, moment)))


def tree_opt_update(opt, grads, opt_state, params):
    """The per-agent optimizer on a stacked tree (or a bare (K, D) stack),
    leaf by leaf and agent by agent. Returns ``(params, opt_state)``."""
    leaves, g_leaves = _leaves(params), _leaves(grads)
    moment = [_is_moment(f, leaves) for f in opt_state]
    m_leaves = [_leaves(f) if m else None
                for f, m in zip(opt_state, moment)]
    new_leaves, new_m = [], [[] for _ in moment]
    counters = list(opt_state)
    for i, (p, g) in enumerate(zip(leaves, g_leaves)):
        s_i = type(opt_state)(*(m_leaves[j][i] if m else f for j, (f, m)
                                in enumerate(zip(opt_state, moment))))
        p_new, s_new = _update_rows(opt, g, s_i, p, moment)
        new_leaves.append(p_new)
        for j, m in enumerate(moment):
            if m:
                new_m[j].append(s_new[j])
            else:
                counters[j] = s_new[j]
    fields = [_unflat(f, new_m[j]) if m else counters[j]
              for j, (f, m) in enumerate(zip(opt_state, moment))]
    return _unflat(params, new_leaves), type(opt_state)(*fields)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _optimizer(fed: FedConfig):
    return get_optimizer(fed.optimizer, fed.lr, maximize=False)


def init_fed_state(cfg: ModelConfig, fed: FedConfig, K: int, key,
                   dtype=torch.float32, device=None) -> FedState:
    """Common init θ_0 in all K rows (``key``: an int seed or a
    ``torch.Generator``, as :func:`repro_torch.models.model.init_params`
    takes it; ``device`` defaults to CUDA, ``"meta"`` gives the shapes
    only). ``params`` and ``prev_params`` are separate tensors."""
    p0 = init_params(cfg, key, dtype, device=device)
    stack = tree_map(lambda leaf: _stack_rows(leaf, K), p0)
    del p0
    return FedState(stack, tree_map(torch.clone, stack),
                    tree_map(_zero_rows, stack),
                    tree_opt_init(_optimizer(fed), stack),
                    torch.zeros((), dtype=torch.int32,
                                device=_leaves(stack)[0].device))


def fed_state_shardings(cfg: ModelConfig, state_shape: FedState,
                        mesh) -> FedState:
    """The specs (:class:`~repro_torch.distributed.sharding.PartitionSpec`)
    of each field of a :class:`FedState` (tensors on any device, ``meta``
    included): the stacks and Adam's (or momentum's) moments by the
    stacked parameter rules, the counters replicated (``PartitionSpec()``).
    Adam's (K,) step is replicated, as in the reference: the step gathers
    the agents' counters over the federation dimensions in rank order."""
    rep = PartitionSpec()

    def pshard(tree):
        return param_shardings(cfg, tree, mesh, stacked=True)

    opt = state_shape.opt_state
    if hasattr(opt, "m") and hasattr(opt, "v"):          # AdamState
        opt_sh = type(opt)(rep, pshard(opt.m), pshard(opt.v))
    elif hasattr(opt, "m"):                              # MomentumState
        opt_sh = type(opt)(pshard(opt.m))
    else:
        opt_sh = tree_map(lambda _: rep, opt)
    return FedState(pshard(state_shape.params),
                    pshard(state_shape.prev_params),
                    pshard(state_shape.v), opt_sh, rep)


def place_fed_state(state: FedState, mesh, cfg: ModelConfig) -> FedState:
    """A tree state every rank holds whole -> the same state on ``mesh``
    (:func:`fed_state_shardings`): each stacked leaf a DTensor of the
    rank's block (``placed.place``: no collective; on a one-rank mesh the
    block is the leaf itself, no copy), each replicated counter a plain
    tensor, the same on every rank. ``mesh`` None gives the state
    back."""
    if mesh is None:
        return state
    return place_tree(state, fed_state_shardings(cfg, state, mesh), mesh)


def place_batch(batch: dict, cfg: ModelConfig, mesh) -> dict:
    """A batch every rank holds whole ((K, b, ...) leaves) -> its blocks
    by :func:`~repro_torch.distributed.sharding.batch_spec`: K over the
    federation dimensions, b over the batch dimensions (a DTensor leaf
    stays as it is)."""
    places = placements(batch_spec(cfg, mesh, stacked=True), mesh)
    return {k: v if columns.is_dtensor(v) else placed.place(v, mesh, places)
            for k, v in batch.items()}


def flat_param_sharding(mesh) -> tuple:
    """The placements of a flat (K, D) stack on ``mesh``: D split by
    ``Shard(1)`` over "model", the agents replicated (``Replicate()`` on
    every other dimension)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(1) if name == "model" else Replicate()
                 for name in mesh.mesh_dim_names)


def flat_fed_state_shardings(mesh, state: FlatFedState) -> FlatFedState:
    """The placements of each field of a :class:`FlatFedState`: every
    (K, D) stack :func:`flat_param_sharding`, the counters replicated."""
    from torch.distributed.tensor import Replicate
    sh = flat_param_sharding(mesh)
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    opt = tree_map(lambda t: sh if t.dim() == 2 else rep, state.opt_state)
    return FlatFedState(sh, sh, sh, opt, rep)


def place_flat_fed_state(state: FlatFedState, mesh) -> FlatFedState:
    """A flat state every rank holds whole -> the same state on ``mesh``
    when its "model" dimension spans more than one rank: each (K, D)
    stack a DTensor of its columns (:func:`flat_fed_state_shardings`),
    each replicated counter a plain tensor, the same on every rank."""
    if mesh is None or mesh_axis_size(mesh, "model") <= 1:
        return state
    specs = flat_fed_state_shardings(mesh, state)
    return tree_map(lambda t, places: columns.shard_columns(t, mesh, places),
                    state, specs)


def init_flat_fed_state(cfg: ModelConfig, fed: FedConfig, K: int, key,
                        dtype=torch.float32, device=None, mesh=None):
    """Common-init flat state. Returns ``(state, unravel)``, where
    ``unravel(row)`` gives one agent's parameter tree as views of the
    (D,) row (``ravel_pytree``'s order). With a ``mesh`` whose "model"
    dimension spans more than one rank, every rank makes the same init
    and keeps its columns of each stack (:func:`place_flat_fed_state`)."""
    p0 = init_params(cfg, key, dtype, device=device)
    vec0 = ravel_tree(p0)
    del p0
    theta = _stack_rows(vec0, K)
    del vec0
    state = FlatFedState(theta, theta.clone(), _zero_rows(theta),
                         _optimizer(fed).init(theta),
                         torch.zeros((), dtype=torch.int32,
                                     device=theta.device))
    return (place_flat_fed_state(state, mesh),
            functools.partial(unravel_tree, shapes=param_shapes(cfg)))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _loss(cfg, params, batch, par=None):
    if "labels" in batch:
        return lm_loss_labeled(cfg, params, batch["tokens"],
                               batch["labels"], batch.get("prefix_embeds"),
                               par)
    return lm_loss(cfg, params, batch["tokens"],
                   batch.get("prefix_embeds"), par)


def _agent_grad(cfg, params_k, batch_k):
    """One agent's loss and its gradient leaves (``tree_paths`` order),
    through leaves detached from the stacks (a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives)."""
    leaves = [t.detach().requires_grad_() for t in _leaves(params_k)]
    with torch.enable_grad():
        loss = _loss(cfg, _unflat(params_k, leaves), batch_k)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, grads)]


def _estimate(cfg, K, agent, out, batch, large: bool,
              written=None) -> torch.Tensor:
    """The PAGE direction of every agent into ``out`` (agent k's views
    from ``agent(out, k)``; ``written(k)``, when given, once they hold
    it); returns the (K,) losses at θ. ``agent(name, k)`` gives agent k's
    tree of ``params``, ``prev`` or ``v``."""
    losses = []
    for k in range(K):
        b = {key: val[k] for key, val in batch.items()}
        loss, g_new = _agent_grad(cfg, agent("params", k), b)
        losses.append(loss)
        dst = _leaves(agent(out, k))
        if large:
            for o, g in zip(dst, g_new):
                o.copy_(g)
        else:
            _, g_old = _agent_grad(cfg, agent("prev", k), b)
            for o, a, b_old, c in zip(dst, g_new, g_old,
                                      _leaves(agent("v", k))):
                o.copy_(a - b_old + c)
            del g_old
        if written is not None:
            written(k)
    return torch.stack(losses)


def _estimate_sharded(cfg, K, sh, state, unravel, batch, large: bool):
    """:func:`_estimate` on D-sharded stacks: each loss needs its agent's
    whole row, so a row is gathered from the ranks in rank order when the
    loss reads it, one agent at a time (a rank's peak grows by rows, not
    by K), and the rank keeps its own columns of each direction. Returns
    ``(tilde_v, losses)``."""
    local = {"params": state.theta.to_local(), "prev": state.prev.to_local(),
             "v": state.v.to_local()}
    out = torch.empty_like(local["params"])
    row = None

    def agent(name, k):
        nonlocal row
        if isinstance(name, str):
            return unravel(sh.gather_row(local[name][k]))
        row = torch.empty(sh.D, dtype=out.dtype, device=out.device)
        return unravel(row)

    def written(k):
        out[k].copy_(row[sh.lo:sh.hi])

    losses = _estimate(cfg, K, agent, None, batch, large, written)
    return sh.wrap(out), losses


def _estimate_placed(cfg, state: FedState, batch: dict, large: bool,
                     lays: list):
    """:func:`_estimate` on a placed state: the rank's own agents only.
    Where no mesh dimension of more than one rank splits an agent's leaves
    or its rows (``fed_axis="all"``, a one-rank mesh) each agent runs the
    plain loss on its leaves; else on the rank's rows and blocks
    (:func:`_estimate_blocks`). Returns ``(tilde_v, losses)``: the
    directions placed like ``state.params``, the (K,) losses gathered
    over the federation dimensions in rank order, the same on every
    rank."""
    lo, hi = lays[0].block(0)
    mesh = lays[0].mesh
    rows = {key: _batch_rows(val, cfg, mesh) for key, val in batch.items()}
    row_dims = _row_dims(cfg, mesh)
    if row_dims or any(mesh.size(m) > 1 for lay in lays
                       for m in lay.trailing):
        out, losses = _estimate_blocks(cfg, state, rows, large, lays,
                                       row_dims)
    else:
        blocks = {name: [placed.local(x) for x in _leaves(tree)]
                  for name, tree in (("params", state.params),
                                     ("prev", state.prev_params),
                                     ("v", state.v))}
        out = [torch.empty_like(x) for x in blocks["params"]]

        def agent(name, k):
            src = blocks[name] if isinstance(name, str) else name
            return _unflat(state.params, [x[k] for x in src])

        losses = _estimate(cfg, hi - lo, agent, out, rows, large)
    tilde_v = _unflat(state.params,
                      [lay.wrap(o) for o, lay in zip(out, lays)])
    return tilde_v, lays[0].agents(losses)


def _row_dims(cfg, mesh) -> list:
    """The mesh dimensions of more than one rank that split an agent's
    batch rows."""
    names = tuple(mesh.mesh_dim_names)
    return [names.index(a) for a in batch_axes(cfg, mesh)
            if a in names and mesh_axis_size(mesh, a) > 1]


def _batch_rows(val, cfg, mesh) -> torch.Tensor:
    """The rank's block of a batch leaf ((K, b, ...), placed by
    :func:`~repro_torch.distributed.sharding.batch_spec`): a DTensor's
    block, or that block of a tensor every rank holds whole."""
    if placed.layout(val) is not None:
        return placed.local(val)
    lay = placed.Layout.of(val.shape, mesh, placements(
        batch_spec(cfg, mesh, stacked=True), mesh))
    return val[lay.index()[:2]]


def _estimate_blocks(cfg, state: FedState, rows: dict, large: bool,
                     lays: list, row_dims: list):
    """The rank's agents' directions on its rows and blocks: each pass
    (``params``, and on a PAGE step ``prev``) runs the model through the
    rank's :func:`~repro_torch.distributed.tensor_parallel.rank_parallel`
    on its rows, with autograd through every collective, so the gradient
    comes out at the rank's block of each leaf. Summed over the row
    dimensions in rank order (a layer split over them is summed at its
    holder in the backward), it is the agent's gradient of the mean loss
    over all its rows; ``a − b + c`` is elementwise on the blocks.
    Returns the direction blocks and the rank's agents' losses, each the
    rank-order mean of its row ranks' losses."""
    mesh = lays[0].mesh
    n = math.prod(mesh.size(m) for m in row_dims)
    per = [lay.without_first() for lay in lays]     # one agent's leaves
    one = _unflat(state.params, per)
    shapes = init_params(cfg, 0, device="meta")
    uses = serve_uses(cfg, shapes, param_shardings(cfg, shapes, mesh), mesh)
    blocks = {name: [placed.local(x) for x in _leaves(tree)]
              for name, tree in (("params", state.params),
                                 ("prev", state.prev_params),
                                 ("v", state.v))}
    sums = [[m for m in row_dims if m not in lay.splits[0]] for lay in per]
    out = [torch.empty_like(x) for x in blocks["params"]]

    def grad(name, k, b):
        leaves = [x[k].detach().requires_grad_() for x in blocks[name]]
        params = _unflat(state.params, leaves)
        par = rank_parallel(cfg, mesh, params, one, uses, rows=row_dims)
        with torch.enable_grad():
            loss = _loss(cfg, params, b, par)
            gs = torch.autograd.grad(loss / n if n > 1 else loss, leaves,
                                     allow_unused=True)
        gs = [placed.rank_sum(torch.zeros_like(t) if g is None else g,
                              mesh, dims)
              for t, g, dims in zip(leaves, gs, sums)]
        return loss.detach(), gs

    losses = []
    for k in range(out[0].shape[0]):
        b = {key: val[k] for key, val in rows.items()}
        loss, g_new = grad("params", k, b)
        losses.append(loss)
        if large:
            for o, g in zip(out, g_new):
                o[k].copy_(g)
        else:
            _, g_old = grad("prev", k, b)
            for o, a, b_old, c in zip(out, g_new, g_old, blocks["v"]):
                o[k].copy_(a - b_old + c[k])
            del g_old
        del g_new
    return out, placed.rank_sum(torch.stack(losses), mesh, row_dims) / n


def _opt_update_placed(opt, v, opt_state, params, lays):
    """:func:`tree_opt_update` on a placed state's blocks (elementwise,
    so each rank updates its own): the moments placed back, the counters
    of the rank's agents advanced and gathered over the federation
    dimensions, the same (K,) tensor on every rank."""
    lo, hi = lays[0].block(0)
    p_leaves = _leaves(params)

    def local(tree):
        return _unflat(tree, [placed.local(x) for x in _leaves(tree)])

    def wrap(tree):
        return _unflat(tree, [lay.wrap(x)
                              for x, lay in zip(_leaves(tree), lays)])

    moment = [_is_moment(f, p_leaves) for f in opt_state]
    new_p, new_opt = tree_opt_update(
        opt, local(v),
        type(opt_state)(*(local(f) if m else f[lo:hi]
                          for f, m in zip(opt_state, moment))),
        local(params))
    return wrap(new_p), type(opt_state)(*(
        wrap(f) if m else lays[0].agents(f)
        for f, m in zip(new_opt, moment)))


def _honest_loss(losses, byz_mask):
    K = byz_mask.shape[0]
    return torch.where(byz_mask, 0.0, losses).mean() * K \
        / torch.clamp_min((~byz_mask).sum(), 1)


def _honest_mean(values, byz_mask):
    return torch.where(byz_mask, 0.0, values).sum() \
        / torch.clamp_min((~byz_mask).sum(), 1)


def _diameter(tree, K: int) -> torch.Tensor:
    if K == 1:
        return torch.zeros((), device=_leaves(tree)[0].device)
    return torch.sqrt(torch.max(agg_lib.stacked_sq_dists(tree)))


def _noise(noise: Optional[FedNoise]) -> FedNoise:
    return FedNoise(None, None) if noise is None else noise


def _mix_dtype(fed: FedConfig):
    return torch.bfloat16 if fed.mix_dtype == "bfloat16" else None


def fed_train_step(cfg: ModelConfig, fed: FedConfig, state: FedState,
                   batch: dict, byz_mask: torch.Tensor,
                   noise: Optional[FedNoise] = None, *, large: bool):
    """One federated step of the tree trainer.

    ``batch``: ``{"tokens": (K, b, S)[, "labels"][, "prefix_embeds": (K,
    b, P, d)]}``; ``byz_mask`` (K,) bool; ``noise`` the step's draws
    (:func:`~repro_torch.core.noise.draw_fed_noise`, None when the attack
    draws nothing); ``large`` the PAGE coin, a Python bool. Returns
    ``(new_state, metrics)``: the honest loss (scaled by K / #honest),
    the diameter and, with ``fed.telemetry``, the honest ``grad_norm``.

    A placed state (:func:`place_fed_state`) takes the placed route: the
    rank's agents' directions (:func:`_estimate_placed`), the placed
    tree's aggregation and agreement, Adam on the blocks; ``batch`` whole
    on every rank or placed (:func:`place_batch`), ``noise`` the whole
    draw (every rank draws the same). The metrics are the same on every
    rank.
    """
    K = byz_mask.shape[0]
    lays = placed.tree_layouts(_leaves(state.params))
    views = {"params": state.params, "prev": state.prev_params,
             "v": state.v}

    def agent(name, k):
        tree = views[name] if isinstance(name, str) else name
        return tree_map(lambda leaf: leaf[k], tree)

    with obs.named_phase("fed.estimate", fed.telemetry):
        if lays is None:
            tilde_v = tree_map(torch.empty_like, state.params)
            losses = _estimate(cfg, K, agent, tilde_v, batch, large)
        else:
            tilde_v, losses = _estimate_placed(cfg, state, batch, large,
                                               lays)

    with obs.named_phase("fed.aggregate", fed.telemetry):
        if K == 1:
            v = tilde_v     # single-agent federation: aggregation is identity
        else:
            tilde_v = agg_lib.attack_stacked(fed.attack, tilde_v, byz_mask,
                                             _noise(noise).attack)
            v = agg_lib.aggregate(fed.aggregator, tilde_v, fed.n_byz)

    metrics = {}
    if fed.telemetry:
        sq = agg_lib.stacked_sq_norms(tilde_v)
        metrics["grad_norm"] = _honest_mean(torch.sqrt(sq), byz_mask)
    del tilde_v

    if lays is None:
        new_params, new_opt = tree_opt_update(_optimizer(fed), v,
                                              state.opt_state, state.params)
    else:
        new_params, new_opt = _opt_update_placed(
            _optimizer(fed), v, state.opt_state, state.params, lays)
    with obs.named_phase("fed.agree", fed.telemetry):
        new_params = agg_lib.gda_agree(new_params, fed.kappa, fed.alpha_bar,
                                       mix_dtype=_mix_dtype(fed),
                                       block=fed.mix_block)

    metrics = {"loss": _honest_loss(losses, byz_mask),
               "diameter": _diameter(new_params, K), **metrics}
    if fed.telemetry:
        obs.tap("fed", step=state.step, **metrics)
    return FedState(new_params, state.params, v, new_opt,
                    state.step + 1), metrics


def make_fed_step(cfg: ModelConfig, fed: FedConfig, mesh, *, large: bool,
                  dtype=torch.float32, per_agent_batch: int = 8,
                  seq_len: int = 512, key=None):
    """The tree trainer's step on ``mesh`` with the PAGE coin ``large``
    fixed. Returns ``(step, state_shape, batch_shape, (state_specs,
    batch_specs, replicated))``: K = ``n_agents(cfg, mesh)``; the state
    and the batch as tensors on the ``meta`` device (the reference's
    ``jax.eval_shape``: int32 tokens and labels (K, per_agent_batch,
    seq_len), or with a frontend (K, b, seq_len − n_prefix_embeds) beside
    ``prefix_embeds`` (K, b, n_prefix_embeds, d_model)); their specs. The
    shapes do not depend on ``key``, which is accepted for the reference's
    signature.

    ``step(state, batch, byz_mask, noise=None)`` places a state or batch
    that every rank holds whole (:func:`place_fed_state`,
    :func:`place_batch`) and runs :func:`fed_train_step`; it takes any K
    that the federation dimensions divide, not only the shapes'. The
    reference's
    ``donate_argnums`` (a JAX compile detail) has no counterpart: the
    step never writes into the state it is given, and a caller that
    rebinds its state lets the old one go."""
    del key
    K = n_agents(cfg, mesh)
    state_shape = init_fed_state(cfg, fed, K, 0, dtype, device="meta")
    state_sh = fed_state_shardings(cfg, state_shape, mesh)
    b_sh = batch_spec(cfg, mesh, stacked=True)
    text = seq_len - (cfg.n_prefix_embeds if cfg.frontend != "none" else 0)
    tok = torch.empty((K, per_agent_batch, text), dtype=torch.int32,
                      device="meta")
    batch = {"tokens": tok, "labels": torch.empty_like(tok)}
    if cfg.frontend != "none":
        batch["prefix_embeds"] = torch.empty(
            (K, per_agent_batch, cfg.n_prefix_embeds, cfg.d_model),
            dtype=dtype, device="meta")
    batch_sh = {k: b_sh for k in batch}

    def step(state, batch, byz_mask, noise=None):
        if placed.tree_layouts(_leaves(state.params)) is None:
            state = place_fed_state(state, mesh, cfg)
        return fed_train_step(cfg, fed, state,
                              place_batch(batch, cfg, mesh), byz_mask,
                              noise, large=large)

    return step, state_shape, batch, (state_sh, batch_sh, PartitionSpec())


def fed_train_step_flat(cfg: ModelConfig, fed: FedConfig,
                        state: FlatFedState, unravel, batch: dict,
                        byz_mask: torch.Tensor,
                        noise: Optional[FedNoise] = None, *, large: bool,
                        sharded: Optional[bool] = None):
    """One federated step on the flat (K, D) stack: the protocol of
    :func:`fed_train_step`, aggregated by the registry aggregator
    ``resolve("aggregator", fed.aggregator, K=K, n_byz=fed.n_byz,
    sharded=sharded)`` (the CUDA kernels on the card), its result
    broadcast to all K rows. A bucketing aggregator (RFA with n_byz > 0:
    Lemma 3) takes the receiver's permutation from ``noise.perm``. With
    ``fed.telemetry`` the metrics add the honest ``grad_norm`` and the
    aggregator's ``rejected`` mask (its own kernel launches: ``gram`` and
    ``krum_score`` for Krum).

    A state on a mesh (:func:`init_flat_fed_state` with ``mesh``: D split
    over "model") takes the D-sharded route: the estimate gathers each
    agent's row from the ranks, the aggregate and agreement combine the
    ranks' Gram partials, the attack, Adam and the PAGE combination run
    on the rank's columns, and ``noise`` is the whole draw (every rank
    draws the same and takes its columns). ``sharded=True`` on a plain
    state is the route with one shard: the ``sharded=None`` step's bits
    and launches."""
    K = byz_mask.shape[0]
    _, sh = columns.local_columns(state.theta)
    if sh is not None and sharded is False:
        raise ValueError("fed_train_step_flat: a state on a mesh takes the "
                         "sharded route; sharded=False cannot gather it")

    with obs.named_phase("fed.estimate", fed.telemetry):
        if sh is None:
            views = {"params": state.theta, "prev": state.prev,
                     "v": state.v}

            def agent(name, k):
                stack = views[name] if isinstance(name, str) else name
                return unravel(stack[k])

            tilde_v = torch.empty_like(state.theta)
            losses = _estimate(cfg, K, agent, tilde_v, batch, large)
        else:
            tilde_v, losses = _estimate_sharded(cfg, K, sh, state, unravel,
                                                batch, large)

    with obs.named_phase("fed.aggregate", fed.telemetry):
        if K == 1:
            v = tilde_v
        else:
            nz = _noise(noise)
            tilde_v = agg_lib.attack_stacked(fed.attack, tilde_v, byz_mask,
                                             nz.attack)
            agg = resolve("aggregator", fed.aggregator, K=K,
                          n_byz=fed.n_byz, sharded=sharded)
            v = columns.on_columns(lambda a: a.expand(K, a.shape[-1]),
                                   agg(tilde_v, nz.perm))

    metrics = {}
    if fed.telemetry:
        metrics["grad_norm"] = _honest_mean(columns.row_norms(tilde_v),
                                            byz_mask)
        metrics["rejected"] = (
            torch.zeros((K,), dtype=torch.bool, device=tilde_v.device)
            if K == 1 else rejection_mask(fed.aggregator, tilde_v,
                                          fed.n_byz))
    del tilde_v

    new_theta, new_opt = _opt_update(_optimizer(fed), v, state, sh)
    with obs.named_phase("fed.agree", fed.telemetry):
        new_theta = agg_lib.gda_agree(new_theta, fed.kappa, fed.alpha_bar,
                                      mix_dtype=_mix_dtype(fed),
                                      block=fed.mix_block)
    metrics = {"loss": _honest_loss(losses, byz_mask),
               "diameter": _diameter(new_theta, K), **metrics}
    if fed.telemetry:
        obs.tap("fed", step=state.step, **metrics)
    return FlatFedState(new_theta, state.theta, v, new_opt,
                        state.step + 1), metrics


def _opt_update(opt, v, state: FlatFedState, sh):
    """The per-agent optimizer on the flat stacks: elementwise, so a
    D-sharded state updates its local columns and wraps them back."""
    if sh is None:
        return tree_opt_update(opt, v, state.opt_state, state.theta)
    local = lambda t: columns.local_columns(t)[0]     # noqa: E731
    new_theta, new_opt = tree_opt_update(
        opt, local(v), tree_map(local, state.opt_state), local(state.theta))
    wrap = lambda t: sh.wrap(t) if t.dim() == 2 else t  # noqa: E731
    return sh.wrap(new_theta), tree_map(wrap, new_opt)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def fed_noise(generator: torch.Generator, fed: FedConfig, state,
              n_byz: int) -> FedNoise:
    """Draw the next step's :class:`FedNoise` for ``state`` (a
    :class:`FedState` or :class:`FlatFedState`) from ``generator``;
    ``n_byz`` is the number of True entries of the step's mask."""
    flat = isinstance(state, FlatFedState)
    rows = state.theta if flat else state.params
    leaves = _leaves(rows)
    D = sum(math.prod(leaf.shape[1:]) for leaf in leaves)
    return draw_fed_noise(generator, fed, leaves[0].shape[0], D, n_byz,
                          flat)


def fed_train_window(cfg: ModelConfig, fed: FedConfig, state: FedState,
                     batches: dict, byz_mask: torch.Tensor, ts,
                     generator: Optional[torch.Generator] = None,
                     noise=None):
    """A window of W tree-trainer steps with one read to the host.

    ``batches``: the per-step batch dicts stacked on a leading W axis
    ((W, K, b, S) tokens/labels); ``ts``: the W global step indices. The
    window first draws its W PAGE coins from ``generator`` (c = 1 at t =
    0; :func:`~repro_torch.core.noise.draw_fed_coins`), then each step's
    :class:`FedNoise` just before the step. ``noise=(coins, [FedNoise,
    ...])`` replays given draws instead. Returns ``(state, metrics)``,
    each metric stacked (W,), plus ``coin``. The window lets go of each
    state once the next is made; a caller that keeps its own reference
    to the start state (a variable it rebinds only on return) keeps that
    state alive through the window, one state more at the peak."""
    ts = [int(t) for t in ts]
    if noise is None:
        n_byz = int(byz_mask.sum())
        coins, steps = draw_fed_coins(generator, ts, fed.page_p), None
    else:
        coins, steps = noise
    rows = []
    for i, t in enumerate(ts):
        batch = {key: val[i] for key, val in batches.items()}
        nz = fed_noise(generator, fed, state, n_byz) if steps is None \
            else steps[i]
        state, metrics = fed_train_step(cfg, fed, state, batch, byz_mask,
                                        nz, large=coins[i])
        rows.append(metrics)
    dev = _leaves(state.params)[0].device
    out = {key: torch.stack([m[key] for m in rows]) for key in rows[0]}
    out["coin"] = torch.tensor(coins, dtype=torch.bool, device=dev)
    return state, out


def common_sample_coin(step: int, seed: int, p: float) -> bool:
    """Common-Sample: the paper's shared coin of the per-step loop, from
    numpy's generator seeded by the common seed and the step (the
    reference's function, bit for bit)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    return bool(step == 0 or rng.random() < p)

"""Averaging agreement (paper Def. 3, App. A.3): MDA and GDA over gossip
graphs, the port of the JAX package's ``core/agreement.py``.

``avg_agree`` runs κ rounds of message passing. In each, every receiver
gathers the messages along its in-edges (the padded ``nbr_idx`` table,
:mod:`repro_torch.topology`), selects a large low-diameter subset and
averages it. All K receivers select in one batched pass: MDA's pairwise
distances are one ``gram`` launch over (K, P, d) per round. Byzantine
senders may equivocate per receiver: receiver r then sees its own slice of
a (K, K, d) attack tensor, along its in-edges only.

The coordinate-wise methods (``cwmean``, ``cwmed``, ``cwtm``) reduce each
neighbour multiset instead of selecting from it: one ``gossip_reduce``
launch per round gathers and reduces for all receivers when one message
matrix is shared (an honest round, or a consistent attack), and
``neighbor_reduce`` reduces the gathered (K, P, d) tensor when the
Byzantine senders equivocate per receiver.

Lane batching adds a leading row axis, θ (L, K, d): the L rows' K
receivers select together (MDA's ``gram`` over (L·K, P, d)), and the
coordinate-wise reduces take the rows folded into the coordinate axis,
(K, L·d), which gives each coordinate the bits of its own row's reduce.
Each launch serves every row.

A D-sharded θ (a DTensor split along d, :mod:`repro_torch.distributed.
columns`) runs the same kernels on each rank's columns: the cw
reduces are coordinate-wise, MDA's distances are the local ``gram``
partials and GDA's the local squared distances, each summed over the
ranks, and the attack's noise is sliced to the rank's columns.
"""
from __future__ import annotations

import functools
import itertools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.registry import REGISTRY, Spec, register, resolve
from repro_torch.carriers.columns import local_columns
from repro_torch.kernels.gossip_reduce import gossip_reduce, neighbor_reduce
from repro_torch.kernels.pairwise_dist import (gram, pairwise_sq_dists,
                                               sq_dists_from_gram)
from repro_torch.topology import resolve_topology

#: Largest neighbor-multiset size ``mda_mean`` enumerates subsets for;
#: C(n, n_keep) grows combinatorially beyond it. The limit applies to the
#: neighborhood, not K.
MDA_MAX_AGENTS = 16


@functools.lru_cache(maxsize=16)
def _subsets(n: int, size: int, device: torch.device) -> torch.Tensor:
    """All index subsets of [n] of the given size, (n_subsets, size), in
    ``itertools.combinations`` order, built once per device."""
    return torch.as_tensor(
        np.array(list(itertools.combinations(range(n), size)),
                 dtype=np.int64), device=device)


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t


def mda_mean(received: torch.Tensor, n_keep: int,
             combine: Callable = _whole) -> torch.Tensor:
    """Exact Minimum-Diameter Averaging: received (B, n, d) -> (B, d), the
    mean of the n_keep-subset of least diameter (the first on ties).
    ``combine`` sums a partial over the ranks holding the other columns
    of d (none: the identity)."""
    B, n, d = received.shape
    if n > MDA_MAX_AGENTS:
        raise ValueError(
            f"mda_mean enumerates C(n, n_keep) subsets and received a "
            f"multiset of size {n} > MDA_MAX_AGENTS={MDA_MAX_AGENTS}; use "
            f"method='gda' or a sparser topology (the limit applies to the "
            f"neighborhood size, not K)")
    subs = _subsets(n, n_keep, received.device)          # (S, n_keep)
    if received.shape[-1]:
        g = gram(received)                               # (B, n, n)
    else:                                                # an empty shard
        g = received.new_zeros((B, n, n))
    d2 = sq_dists_from_gram(combine(g))
    sub_d = d2[:, subs[:, :, None], subs[:, None, :]]    # (B, S, nk, nk)
    diam = sub_d.reshape(B, subs.shape[0], -1).amax(-1)
    best = subs[torch.argmin(diam, dim=1)]               # (B, n_keep)
    rows = torch.arange(B, device=received.device)[:, None]
    return received[rows, best].mean(1)


def gda_mean(received: torch.Tensor, own: torch.Tensor, n_keep: int,
             combine: Callable = _whole) -> torch.Tensor:
    """Greedy Diameter Averaging: received (B, n, d), own (B, d) -> (B, d),
    the mean of the n_keep vectors closest to the agent's own (the lower
    index first on ties, as ``lax.top_k``)."""
    d2 = combine(((received - own[:, None, :]) ** 2).sum(-1))
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :n_keep]
    rows = torch.arange(received.shape[0], device=received.device)[:, None]
    return received[rows, idx].mean(1)


class AgreementMethod(NamedTuple):
    """A resolved agreement rule. Selection methods (MDA/GDA) carry
    ``select(received, own, n_keep)`` and the tolerated ``alpha_bar``;
    coordinate-wise methods carry ``reduce`` (a gossip-reduce mode) and
    ``n_trim`` instead."""
    select: Optional[Callable]
    alpha_bar: float
    reduce: Optional[str] = None
    n_trim: int = 0


@register("agreement", "mda", max_agents=MDA_MAX_AGENTS)
def _mda_factory(alpha_bar: float = 0.25):
    return AgreementMethod(
        lambda recv, own, n_keep, combine=_whole: mda_mean(recv, n_keep,
                                                           combine),
        alpha_bar)


@register("agreement", "gda")
def _gda_factory(alpha_bar: float = 0.2):
    return AgreementMethod(gda_mean, alpha_bar)


@register("agreement", "cwmean")
def _cwmean_factory():
    """Plain gossip averaging: no Byzantine tolerance."""
    return AgreementMethod(None, 0.0, reduce="mean")


@register("agreement", "cwmed")
def _cwmed_factory():
    """Coordinate-wise median over each neighbour multiset."""
    return AgreementMethod(None, 0.5, reduce="median")


@register("agreement", "cwtm")
def _cwtm_factory(n_byz: int = 0, n_trim: Optional[int] = None):
    """Coordinate-wise trimmed mean over each neighbour multiset, trimming
    ``n_trim`` (default: the config's ``n_byz``) from each tail; needs
    ``deg_max > 2·n_trim``."""
    nt = n_byz if n_trim is None else n_trim
    return AgreementMethod(None, 0.25, reduce="trimmed", n_trim=nt)


def avg_agree(theta: torch.Tensor, kappa: int, n_byz: int,
              byz_mask: Optional[torch.Tensor] = None, method="gda",
              attack: Optional[Callable] = None,
              noise: Optional[torch.Tensor] = None,
              alpha_bar: Optional[float] = None,
              topology=None, sharded: Optional[bool] = None
              ) -> torch.Tensor:
    """Simulate Avg-Agree_κ over K agents (paper Algorithm 3 on a gossip
    graph).

    theta: (K, d) current parameters, or (L, K, d) for L rows. attack:
    ``fn(broadcast (K, d), byz_mask, noise) -> (K_send, d)`` or, per
    receiver, ``(K_recv, K_send, d)`` (with the row axis in front when
    there are rows); None is an honest broadcast. noise: the attack's
    draws for all rounds, (κ, ...) with the attack's own noise shape per
    round ((L, κ, ...) for rows), or None when it draws none. alpha_bar:
    the tolerated Byzantine fraction that sets how many neighbours an
    agent keeps, in place of the method's own. Returns the
    parameters after κ rounds, in θ's shape (Byzantine rows carry what an
    honest agent in that slot would compute; callers mask them).

    A D-sharded θ runs every round on the rank's columns and returns a
    DTensor of the same placement. ``sharded=True`` on a plain tensor is
    that route with one shard: the same kernels, bit for bit (the
    reference's flag only swapped its kernels for their ``jnp`` oracles).
    """
    K = theta.shape[-2]
    theta, sh = local_columns(theta)
    lanes = theta.dim() == 3
    if sh is not None and sharded is False:
        raise ValueError("avg_agree: a D-sharded theta takes the sharded "
                         "route; sharded=False cannot gather it")
    combine = _whole if sh is None else sh.sum
    if sh is not None and noise is not None:
        noise = noise[..., sh.lo:sh.hi]
    m = resolve("agreement", method, n_byz=n_byz)
    topo = resolve_topology(topology, K)
    nbr = torch.as_tensor(topo.nbr_idx, dtype=torch.int64,
                          device=theta.device)           # (K, P)
    P = topo.deg_max
    alpha_bar = m.alpha_bar if alpha_bar is None else alpha_bar
    # never forced to include a Byzantine: n_keep <= P - n_byz
    n_keep = max(min(int(np.ceil((1.0 - alpha_bar) * P)), P - n_byz), 1)
    limit = REGISTRY.meta("agreement", method).get("max_agents")
    if limit is not None and P > limit:
        raise ValueError(
            f"agreement method {Spec.of(method).name!r} supports neighbor "
            f"multisets up to {limit}, but topology {topo.name!r} has "
            f"deg_max={P}; use 'gda' or a sparser topology")
    if byz_mask is None:
        byz_mask = torch.zeros(K, dtype=torch.bool, device=theta.device)
    rows = torch.arange(K, device=theta.device)[:, None]
    for r in range(kappa):
        sent, recv = theta, None
        if attack is not None:
            a = attack(theta, byz_mask, None if noise is None
                       else noise[:, r] if lanes else noise[r])
            if a.dim() > theta.dim():
                # receiver r sees its own adversarial slice a[r] along its
                # in-edges; honest senders deliver their true value
                recv = torch.where(byz_mask[nbr][:, :, None],
                                   a[..., rows, nbr, :], theta[..., nbr, :])
            else:
                sent = torch.where(byz_mask[:, None], a, theta)
        if m.reduce is None:
            received = sent[..., nbr, :] if recv is None else recv
            if lanes:                    # the rows' receivers together
                d = theta.shape[-1]
                theta = m.select(received.reshape(-1, P, d),
                                 theta.reshape(-1, d), n_keep,
                                 combine).reshape(theta.shape)
            else:
                theta = m.select(received, theta, n_keep, combine)
        elif not theta.shape[-1]:
            pass                         # an empty shard reduces nothing
        elif recv is None:
            # one message matrix for all receivers: gather + reduce fused
            theta = _unfold(gossip_reduce(_fold(sent), nbr, m.reduce,
                                          m.n_trim), theta) if lanes \
                else gossip_reduce(sent, nbr, m.reduce, m.n_trim)
        else:
            theta = _unfold(neighbor_reduce(_fold(recv), m.reduce,
                                            m.n_trim), theta) if lanes \
                else neighbor_reduce(recv, m.reduce, m.n_trim)
    return theta if sh is None else sh.wrap(theta)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Rows folded into the coordinate axis: (L, K, d) -> (K, L·d), or
    (L, K, P, d) -> (K, P, L·d)."""
    return x.movedim(0, -2).reshape(*x.shape[1:-1], -1)


def _unfold(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K, L·d) back to ``like``'s (L, K, d), contiguous as the kernels
    take it."""
    L, K, d = like.shape
    return y.reshape(K, L, d).transpose(0, 1).contiguous()


def honest_diameter(theta: torch.Tensor,
                    honest_mask: torch.Tensor) -> torch.Tensor:
    """max_{i,l honest} ||θ_i - θ_l||, the paper's Δ₂ diagnostic: a
    scalar for θ (K, d), (L,) for L rows' θ (L, K, d) (one ``gram``
    launch either way)."""
    d2 = pairwise_sq_dists(theta if theta.dim() == 3 else theta[None])
    m = honest_mask[:, None] & honest_mask[None, :]
    out = torch.sqrt(torch.where(m, d2, 0.0).amax((-2, -1)))
    return out if theta.dim() == 3 else out[0]

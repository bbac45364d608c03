"""(α, C_ra)-robust aggregation (paper Def. 1, App. A.2): the port of the
JAX package's ``core/aggregators.py``.

The base rules are batched: ``(Bt, K, d) -> (Bt, d)``. A resolved
aggregator is an :class:`Aggregator`, called on the (K, d) messages with
the receivers' bucketing permutations:

* without bucketing every receiver aggregates the same set, so it is
  aggregated once and the result is (1, d);
* with bucketing (Lemma 3, or the explicit ``bucketing`` spec) each of the
  R receivers permutes the messages with its own row of ``perm`` (R, K),
  averages buckets, and aggregates the bucket means; all R go through the
  base rule in one batched call, and the result is (R, d).

Lane batching adds a leading row axis: messages (L, K, d) and
permutations (L, R, K) give (L, 1, d) or (L, R, d), the L rows' batches
folded into the base rule's one batched call. A factory kwarg registered
as ``traced_kwargs`` (``rfa``'s ``nu``, ``centered_clip``'s ``tau``) may
then be an (L,) tensor, one value per row, which each row's batch
elements share; the other numeric kwargs are ``static_kwargs``, part of
the rule's structure.

RFA runs the Gram-space kernels of :mod:`repro_torch.kernels.rfa`, Krum
the ``gram`` and ``krum_score`` kernels, the trimmed mean the
``trimmed_mean`` kernel. ``suspicion_scores`` and ``rejection_mask`` are
the reference's per-sender forensics view of one (K, d) round.

A D-sharded stack (a DTensor split along d, :mod:`repro_torch.distributed.
columns`) runs the same bodies on the rank's local columns: Krum's and
RFA's Gram matrices are the local ``gram`` partials summed over the
ranks, so every rank picks the same rows and weights; the weighted sums,
row picks, trimmed means, medians and bucket means stay local; centered
clipping's and the suspicion scores' norms and counts are local partials
summed over the ranks. A plain tensor is that route with one shard.
``sharded=`` (on ``krum``, ``rfa``, ``trimmed_mean`` and their factories)
is the reference's flag, accepted and needing no action here: the input
says which route it takes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.registry import Spec, register, resolve
from repro_torch.carriers.columns import (Shards, local_columns, norms,
                                             on_columns, rewrap)
from repro_torch.kernels.krum_score import krum_score
from repro_torch.kernels.pairwise_dist import gram
from repro_torch.kernels.rfa import weighted_sum, weiszfeld_weights
from repro_torch.kernels.trimmed_mean import trimmed_mean as \
    trimmed_mean_kernel


def combined_gram(x: torch.Tensor, sh: Optional[Shards] = None
                  ) -> torch.Tensor:
    """(Bt, K, K) Gram matrices of the (Bt, K, d) columns ``x``, summed
    over the ranks that hold the other columns (``sh``; None: ``x`` is
    all of them): the ``gram`` kernel, nothing launched on an empty
    shard."""
    bt, k, d = x.shape
    g = gram(x) if d else x.new_zeros((bt, k, k))
    return g if sh is None else sh.sum(g)


# ---------------------------------------------------------------------------
# Base rules, batched over a leading dim
# ---------------------------------------------------------------------------

def mean(x: torch.Tensor) -> torch.Tensor:
    return on_columns(lambda t: t.mean(-2), x)


def per_batch(value, bt: int):
    """A traced kwarg for a batch of ``bt`` elements: a number as it is,
    or an (L,) tensor of the rows' values repeated for each row's
    ``bt / L`` consecutive batch elements."""
    if not isinstance(value, torch.Tensor):
        return value
    if bt % value.numel():
        raise ValueError(f"{value.numel()} per-row values cannot cover a "
                         f"batch of {bt}")
    return value.reshape(-1).repeat_interleave(bt // value.numel())


def rfa(x: torch.Tensor, n_iter: int = 32, nu: float = 1e-6,
        sharded: Optional[bool] = None, *, gram_of=combined_gram
        ) -> torch.Tensor:
    """Robust Federated Averaging: smoothed-Weiszfeld geometric median in
    Gram space: ``weiszfeld`` on the Gram matrices
    (``gram_of(local, shards)``, :func:`combined_gram` unless the flat
    layer's blocked route passes its own), then ``wsum`` on the local
    columns. ``nu`` is a number or one value per row
    (:func:`per_batch`)."""
    local, sh = local_columns(x)
    w = weiszfeld_weights(gram_of(local, sh),
                          per_batch(nu, local.shape[0]), n_iter)
    out = weighted_sum(local, w) if local.shape[-1] else \
        local.new_zeros((local.shape[0], 0))
    return rewrap(out, sh)


def krum(x: torch.Tensor, n_byz: int, m: int = 1,
         sharded: Optional[bool] = None, *, gram_of=combined_gram
         ) -> torch.Tensor:
    """(Multi-)Krum: score_i = Σ_{j in closest K-n_byz-2} ||x_j - x_i||²
    (``krum_score`` on the Gram matrices of ``gram_of``, as in
    :func:`rfa`); the lowest-scoring input's local columns (the first on
    ties), or the mean of the m lowest (a stable sort, so ties keep the
    lower index as ``lax.top_k`` does)."""
    local, sh = local_columns(x)
    Bt, K, _ = local.shape
    scores = krum_score(gram_of(local, sh), max(K - n_byz - 2, 1))
    rows = torch.arange(Bt, device=local.device)
    if m == 1:
        out = local[rows, torch.argmin(scores, dim=1)]
    else:
        idx = torch.sort(scores, dim=1, stable=True).indices[:, :m]
        out = local[rows[:, None], idx].mean(1)
    return rewrap(out, sh)


def trimmed_mean(x: torch.Tensor, n_byz: int,
                 sharded: Optional[bool] = None) -> torch.Tensor:
    """Coordinate-wise: drop the n_byz largest and smallest per coordinate
    (the ``trimmed_mean`` kernel on the local columns: the one-process
    bits whatever the split)."""
    return on_columns(lambda t: trimmed_mean_kernel(t, n_byz)
                      if t.shape[-1] else t.new_zeros((t.shape[0], 0)), x)


def _median(x: torch.Tensor) -> torch.Tensor:
    K = x.shape[-2]
    s = torch.sort(x, dim=-2).values
    return (s[..., (K - 1) // 2, :] + s[..., K // 2, :]) / 2


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median; an even count averages the two middle
    values, as ``jnp.median``."""
    return on_columns(_median, x)


def centered_clip(x: torch.Tensor, tau: float = 1.0, n_iter: int = 5,
                  center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Centered clipping: v <- v + mean_i clip(x_i - v, tau), started at
    the coordinate-wise median (or ``center``, in ``x``'s form). The
    norms of x_i - v sum the ranks' partials; the rest is local. ``tau``
    is a number or one value per row (:func:`per_batch`)."""
    local, sh = local_columns(x)
    tau = per_batch(tau, local.shape[0])
    if isinstance(tau, torch.Tensor):
        tau = tau[:, None, None]
    v = _median(local) if center is None else local_columns(center)[0]
    for _ in range(n_iter):
        diff = local - v[..., None, :]
        norm = norms(diff, sh)[..., None]
        clipped = diff * torch.clamp(tau / torch.clamp_min(norm, 1e-12),
                                     max=1.0)
        v = v + clipped.mean(-2)
    return rewrap(v, sh)


def suspicion_scores(spec, x: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Per-sender Byzantine-suspicion scores (K,) of one round x (K, d),
    or (L, K) of L rows' rounds (L, K, d): Krum's score, the trimmed-mean
    family's share of coordinates in which the sender was trimmed, and
    otherwise the distance from the coordinate-wise median. A diagnostic
    view, not the aggregation (bucketed variants score the raw messages).
    On a D-sharded x the Krum scores come from the combined Gram matrix,
    the trim share from the ranks' counts and the distance from their
    sums of squares."""
    spec = Spec.of(spec)
    K = x.shape[-2]
    local, sh = local_columns(x)
    if spec.name == "krum":
        n_near = max(K - max(n_byz, 1) - 2, 1)
        if local.dim() == 3:
            return krum_score(combined_gram(local), n_near)
        return krum_score(combined_gram(local[None], sh), n_near)[0]
    if spec.name in ("trimmed_mean", "cwtm"):
        nt = max(n_byz, 1)
        # rank of each sender per coordinate; trimmed = in either tail
        ranks = torch.argsort(torch.argsort(local, dim=-2, stable=True),
                              dim=-2, stable=True)
        trimmed = (ranks < nt) | (ranks >= K - nt)
        if sh is None:
            return trimmed.to(x.dtype).mean(-1)
        return sh.sum(trimmed.sum(1)).to(x.dtype) / sh.D
    med = _median(local)
    sq = ((local - med[..., None, :]) ** 2).sum(-1)
    return torch.sqrt(sq if sh is None else sh.sum(sq))


def rejection_mask(spec, x: torch.Tensor, n_byz: int) -> torch.Tensor:
    """(K,) bool, or (L, K) for L rows: the n_byz most suspicious senders
    of the round, per :func:`suspicion_scores` (the lower index first on
    ties, as ``lax.top_k``); all False when n_byz == 0."""
    mask = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    if n_byz <= 0:
        return mask
    scores = suspicion_scores(spec, x, n_byz)
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :n_byz]
    return mask.scatter(-1, idx, True)


def resilient_momentum_update(agg: Callable, momenta: torch.Tensor,
                              beta: float, grads: torch.Tensor,
                              perm: Optional[torch.Tensor] = None):
    """Resilient averaging of momentums: m_i <- beta m_i + (1-beta) g_i,
    then the robust aggregate of the momenta. Returns (new_momenta,
    direction); momenta and grads (K, d)."""
    new_m = beta * momenta + (1.0 - beta) * grads
    return new_m, agg(new_m, perm)


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

def _bucket_means(x: torch.Tensor, perm: torch.Tensor,
                  bucket_size: int) -> torch.Tensor:
    K, d = x.shape[-2:]
    n_buckets = -(-K // bucket_size)
    pad = n_buckets * bucket_size - K
    idx = torch.cat([perm, perm[..., :pad]], dim=-1) if pad else perm
    if x.dim() == 3:            # rows: each gathers from its own messages
        rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
        picked = x[rows, idx]
    else:
        picked = x[idx]
    n = idx[..., 0].numel()     # receivers, over all rows
    return picked.reshape(n, n_buckets, bucket_size, d).mean(2)


def bucket_means(x: torch.Tensor, perm: torch.Tensor,
                 bucket_size: int) -> torch.Tensor:
    """x (K, d), perm (R, K) -> (R, n_buckets, d): each receiver permutes
    the inputs, pads by repeating its first permuted entries so every
    bucket is full, and averages buckets of ``bucket_size``. With a row
    axis, x (L, K, d) and perm (L, R, K) give the rows' receivers
    (L·R, n_buckets, d), row-major. Bucketing commutes with a split of d:
    a D-sharded x buckets its local columns."""
    return on_columns(_bucket_means, x, perm, bucket_size)


class Aggregator(NamedTuple):
    """A resolved aggregation rule: the batched base rule ``fn`` and the
    bucket size (0: no bucketing, no permutation drawn)."""
    fn: Callable
    bucket_size: int = 0

    def __call__(self, x: torch.Tensor,
                 perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (K, d) messages -> (1, d), or (R, d) for R permutations; with
        a row axis, x (L, K, d) and perm (L, R, K) -> (L, 1, d) or
        (L, R, d), in one call of the base rule."""
        rows = x.dim() == 3
        if not self.bucket_size:
            return self.fn(x)[:, None] if rows else \
                self.fn(on_columns(lambda t: t[None], x))
        if perm is None:
            raise ValueError("a bucketing aggregator needs the receivers' "
                             "permutations")
        out = self.fn(bucket_means(x, perm, self.bucket_size))
        return out.reshape(x.shape[0], perm.shape[-2], -1) if rows else out


def _lemma3_bucket_size(K: int, n_byz: int, alpha_max: float) -> int:
    """Bucket size per Lemma 3: ``floor(alpha_max / alpha)`` with
    ``alpha = n_byz / K`` (1, i.e. no bucketing, when n_byz == 0)."""
    if n_byz == 0:
        return 1
    return max(1, int(alpha_max / max(n_byz / K, 1e-9)))


@register("aggregator", "mean")
def _mean_factory():
    return Aggregator(mean)


@register("aggregator", "krum", static_kwargs=("m", "alpha_max"))
def _krum_factory(K, n_byz, m: int = 1, alpha_max: float = 0.25,
                  sharded: Optional[bool] = None):
    """Lemma-3 bucketing ∘ Krum (alpha_max 1/4); the inner Krum tolerates
    a quarter of the buckets."""
    bs = _lemma3_bucket_size(K, n_byz, alpha_max)
    if bs == 1:
        return Aggregator(lambda x: krum(x, n_byz=max(n_byz, 1), m=m,
                                         sharded=sharded))
    inner_byz = max(1, -(-K // bs) // 4)
    return Aggregator(lambda x: krum(x, n_byz=inner_byz, m=m,
                                     sharded=sharded), bs)


@register("aggregator", "rfa", traced_kwargs=("nu",),
          static_kwargs=("n_iter", "alpha_max"))
def _rfa_factory(K, n_byz, n_iter: int = 32, nu=1e-6,
                 alpha_max: float = 0.5, sharded: Optional[bool] = None):
    bs = _lemma3_bucket_size(K, n_byz, alpha_max)
    return Aggregator(lambda x: rfa(x, n_iter=n_iter, nu=nu,
                                    sharded=sharded),
                      bs if bs > 1 else 0)


@register("aggregator", "cwmed")
def _cwmed_factory():
    return Aggregator(coordinate_median)


@register("aggregator", "trimmed_mean")
def _trimmed_mean_factory(n_byz, sharded: Optional[bool] = None):
    return Aggregator(lambda x: trimmed_mean(x, max(n_byz, 1),
                                             sharded=sharded))


@register("aggregator", "centered_clip", traced_kwargs=("tau",),
          static_kwargs=("n_iter",))
def _centered_clip_factory(tau=1.0, n_iter: int = 5):
    return Aggregator(lambda x: centered_clip(x, tau=tau, n_iter=n_iter))


@register("aggregator", "bucketing", static_kwargs=("s",))
def _bucketing_factory(K, n_byz, inner, s: int = 2,
                       sharded: Optional[bool] = None):
    """Explicit bucketing with a fixed bucket size ``s`` around an inner
    aggregator spec, e.g. ``bucketing(inner=rfa(n_iter=64), s=2)``. The
    inner spec resolves against the bucket means with n_byz 0, so it does
    not bucket a second time; ``sharded`` passes on to it."""
    inner_agg = resolve("aggregator", inner, K=-(-K // s), n_byz=0,
                        sharded=sharded)
    if inner_agg.bucket_size:
        raise ValueError(f"bucketing: inner aggregator {inner} buckets "
                         f"again; nest one bucketing only")
    return Aggregator(inner_agg.fn, s)


def get_aggregator(name, K: int, n_byz: int,
                   alpha_max: Optional[float] = None) -> Aggregator:
    """Resolve an aggregator spec (name, spec string, or Spec) against the
    federation shape: the reference's entry point, returning the port's
    :class:`Aggregator` (called with the receivers' permutations where
    the reference takes a key). ``alpha_max`` is context, ignored by the
    factories that take none; explicit spec kwargs win."""
    ctx = {"K": K, "n_byz": n_byz}
    if alpha_max is not None:
        ctx["alpha_max"] = alpha_max
    return resolve("aggregator", Spec.of(name), **ctx)

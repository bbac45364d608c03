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

RFA runs the Gram-space kernels of :mod:`repro_torch.kernels.rfa`, Krum
the ``gram`` and ``krum_score`` kernels, the trimmed mean the
``trimmed_mean`` kernel. ``suspicion_scores`` and ``rejection_mask`` are
the reference's per-sender forensics view of one (K, d) round. The
reference's ``sharded=`` routes wait for the ``distributed/`` slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.registry import Spec, register, resolve
from repro_torch.kernels.krum_score import krum_scores
from repro_torch.kernels.rfa import rfa as rfa_kernel
from repro_torch.kernels.trimmed_mean import trimmed_mean as \
    trimmed_mean_kernel


# ---------------------------------------------------------------------------
# Base rules, batched over a leading dim
# ---------------------------------------------------------------------------

def mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(-2)


def rfa(x: torch.Tensor, n_iter: int = 32, nu: float = 1e-6) -> torch.Tensor:
    """Robust Federated Averaging: smoothed-Weiszfeld geometric median in
    Gram space (``gram`` -> ``weiszfeld`` -> ``wsum``)."""
    return rfa_kernel(x, n_iter=n_iter, nu=nu)


def krum(x: torch.Tensor, n_byz: int, m: int = 1) -> torch.Tensor:
    """(Multi-)Krum: score_i = Σ_{j in closest K-n_byz-2} ||x_j - x_i||²
    (``gram`` -> ``krum_score``); the lowest-scoring input (the first on
    ties), or the mean of the m lowest (a stable sort, so ties keep the
    lower index as ``lax.top_k`` does)."""
    Bt, K, _ = x.shape
    scores = krum_scores(x, max(K - n_byz - 2, 1))             # (Bt, K)
    rows = torch.arange(Bt, device=x.device)
    if m == 1:
        return x[rows, torch.argmin(scores, dim=1)]
    idx = torch.sort(scores, dim=1, stable=True).indices[:, :m]
    return x[rows[:, None], idx].mean(1)


def trimmed_mean(x: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Coordinate-wise: drop the n_byz largest and smallest per coordinate
    (the ``trimmed_mean`` kernel)."""
    return trimmed_mean_kernel(x, n_byz)


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median; an even count averages the two middle
    values, as ``jnp.median``."""
    K = x.shape[-2]
    s = torch.sort(x, dim=-2).values
    return (s[..., (K - 1) // 2, :] + s[..., K // 2, :]) / 2


def centered_clip(x: torch.Tensor, tau: float = 1.0, n_iter: int = 5,
                  center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Centered clipping: v <- v + mean_i clip(x_i - v, tau), started at
    the coordinate-wise median."""
    v = coordinate_median(x) if center is None else center
    for _ in range(n_iter):
        diff = x - v[..., None, :]
        norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
        clipped = diff * torch.clamp(tau / torch.clamp_min(norm, 1e-12),
                                     max=1.0)
        v = v + clipped.mean(-2)
    return v


def suspicion_scores(spec, x: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Per-sender Byzantine-suspicion scores (K,) of one round x (K, d):
    Krum's score, the trimmed-mean family's share of coordinates in which
    the sender was trimmed, and otherwise the distance from the
    coordinate-wise median. A diagnostic view, not the aggregation
    (bucketed variants score the raw messages)."""
    spec = Spec.of(spec)
    K = x.shape[0]
    if spec.name == "krum":
        return krum_scores(x[None], max(K - max(n_byz, 1) - 2, 1))[0]
    if spec.name in ("trimmed_mean", "cwtm"):
        nt = max(n_byz, 1)
        # rank of each sender per coordinate; trimmed = in either tail
        ranks = torch.argsort(torch.argsort(x, dim=0, stable=True), dim=0,
                              stable=True)
        trimmed = (ranks < nt) | (ranks >= K - nt)
        return trimmed.to(x.dtype).mean(1)
    med = coordinate_median(x)
    return torch.sqrt(((x - med[None]) ** 2).sum(1))


def rejection_mask(spec, x: torch.Tensor, n_byz: int) -> torch.Tensor:
    """(K,) bool: the n_byz most suspicious senders of the round, per
    :func:`suspicion_scores` (the lower index first on ties, as
    ``lax.top_k``); all False when n_byz == 0."""
    K = x.shape[0]
    mask = torch.zeros(K, dtype=torch.bool, device=x.device)
    if n_byz <= 0:
        return mask
    scores = suspicion_scores(spec, x, n_byz)
    idx = torch.sort(scores, descending=True, stable=True).indices[:n_byz]
    mask[idx] = True
    return mask


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

def bucket_means(x: torch.Tensor, perm: torch.Tensor,
                 bucket_size: int) -> torch.Tensor:
    """x (K, d), perm (R, K) -> (R, n_buckets, d): each receiver permutes
    the inputs, pads by repeating its first permuted entries so every
    bucket is full, and averages buckets of ``bucket_size``."""
    K, d = x.shape
    n_buckets = -(-K // bucket_size)
    pad = n_buckets * bucket_size - K
    idx = torch.cat([perm, perm[:, :pad]], dim=1) if pad else perm
    R = perm.shape[0]
    return x[idx].reshape(R, n_buckets, bucket_size, d).mean(2)


class Aggregator(NamedTuple):
    """A resolved aggregation rule: the batched base rule ``fn`` and the
    bucket size (0: no bucketing, no permutation drawn)."""
    fn: Callable
    bucket_size: int = 0

    def __call__(self, x: torch.Tensor,
                 perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (K, d) messages -> (1, d), or (R, d) for R permutations."""
        if not self.bucket_size:
            return self.fn(x[None])
        if perm is None:
            raise ValueError("a bucketing aggregator needs the receivers' "
                             "permutations")
        return self.fn(bucket_means(x, perm, self.bucket_size))


def _lemma3_bucket_size(K: int, n_byz: int, alpha_max: float) -> int:
    """Bucket size per Lemma 3: ``floor(alpha_max / alpha)`` with
    ``alpha = n_byz / K`` (1, i.e. no bucketing, when n_byz == 0)."""
    if n_byz == 0:
        return 1
    return max(1, int(alpha_max / max(n_byz / K, 1e-9)))


@register("aggregator", "mean")
def _mean_factory():
    return Aggregator(mean)


@register("aggregator", "krum")
def _krum_factory(K, n_byz, m: int = 1, alpha_max: float = 0.25):
    """Lemma-3 bucketing ∘ Krum (alpha_max 1/4); the inner Krum tolerates
    a quarter of the buckets."""
    bs = _lemma3_bucket_size(K, n_byz, alpha_max)
    if bs == 1:
        return Aggregator(lambda x: krum(x, n_byz=max(n_byz, 1), m=m))
    inner_byz = max(1, -(-K // bs) // 4)
    return Aggregator(lambda x: krum(x, n_byz=inner_byz, m=m), bs)


@register("aggregator", "rfa")
def _rfa_factory(K, n_byz, n_iter: int = 32, nu=1e-6,
                 alpha_max: float = 0.5):
    bs = _lemma3_bucket_size(K, n_byz, alpha_max)
    return Aggregator(lambda x: rfa(x, n_iter=n_iter, nu=nu),
                      bs if bs > 1 else 0)


@register("aggregator", "cwmed")
def _cwmed_factory():
    return Aggregator(coordinate_median)


@register("aggregator", "trimmed_mean")
def _trimmed_mean_factory(n_byz):
    return Aggregator(lambda x: trimmed_mean(x, max(n_byz, 1)))


@register("aggregator", "centered_clip")
def _centered_clip_factory(tau=1.0, n_iter: int = 5):
    return Aggregator(lambda x: centered_clip(x, tau=tau, n_iter=n_iter))


@register("aggregator", "bucketing")
def _bucketing_factory(K, n_byz, inner, s: int = 2):
    """Explicit bucketing with a fixed bucket size ``s`` around an inner
    aggregator spec, e.g. ``bucketing(inner=rfa(n_iter=64), s=2)``. The
    inner spec resolves against the bucket means with n_byz 0, so it does
    not bucket a second time."""
    inner_agg = resolve("aggregator", inner, K=-(-K // s), n_byz=0)
    if inner_agg.bucket_size:
        raise ValueError(f"bucketing: inner aggregator {inner} buckets "
                         f"again; nest one bucketing only")
    return Aggregator(inner_agg.fn, s)

"""Communication topologies for decentralized agreement: a numpy copy of
the JAX package's ``topology/graphs.py`` (DESIGN.md §5).

A topology is a static directed graph over the K agents: ``adjacency[r, s]``
means receiver ``r`` hears sender ``s``. Every agent always hears itself
(the diagonal is forced True), matching the paper's convention that an
agent's own vector is part of the multiset it selects over.

Topologies are *static*: generators produce numpy adjacency masks, so a
``topology`` spec can sit in a frozen config dataclass. The runtime
representation is the padded neighbor-index table ``nbr_idx (K, deg_max)``
— receiver ``r``'s sender indices in ascending order, padded with ``r``
itself — so the agreement core gathers a fixed-shape ``(K, deg_max, d)``
received tensor whatever each receiver's degree. Padding with the
receiver's own index (rather than a sentinel + validity mask) keeps every
slot a real message: low-degree agents simply see extra copies of their
own value, a lazy-gossip self-weight that needs no masked selection rule.
On the complete graph ``nbr_idx[r] == arange(K)``, so the gather is the
identity and the masked core reproduces the historical all-to-all
broadcast exactly.

Diagnostics bound Byzantine feasibility: ``min_in_degree`` (excluding
self) upper-bounds vertex connectivity, the Fiedler value
``algebraic_connectivity`` of the symmetrized graph lower-bounds it
(Fiedler's inequality), and ``spectral_gap`` of the uniform gossip matrix
governs the honest-diameter contraction rate. The classic BFT condition
is connectivity > 2·n_byz; :meth:`Topology.tolerates` checks the
*necessary* version of it against ``min_in_degree``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.registry import Spec, register, resolve


class Topology(NamedTuple):
    """A resolved communication graph plus its diagnostics.

    ``adjacency`` is the (K, K) bool mask (diagonal True); ``nbr_idx`` the
    padded (K, deg_max) int32 sender table the agreement core gathers
    with; degrees and spectra are host floats/ints for reporting.
    """
    spec: Spec
    adjacency: np.ndarray            # (K, K) bool, adjacency[r, s]
    nbr_idx: np.ndarray              # (K, deg_max) int32, padded with self
    in_degree: np.ndarray            # (K,) int32, including self
    min_in_degree: int               # excluding self
    spectral_gap: float              # 1 - |lambda_2| of uniform gossip W
    algebraic_connectivity: float    # Fiedler value of symmetrized graph

    @property
    def K(self) -> int:
        return self.adjacency.shape[0]

    @property
    def deg_max(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def name(self) -> str:
        return self.spec.canonical()

    @property
    def density(self) -> float:
        """Off-diagonal edge fraction in [0, 1] (1 = complete)."""
        K = self.K
        if K <= 1:
            return 1.0
        off = int(self.adjacency.sum()) - K
        return off / (K * (K - 1))

    def is_complete(self) -> bool:
        return bool(self.adjacency.all())

    def tolerates(self, n_byz: int) -> bool:
        """Necessary BFT condition: every agent hears > 2·n_byz peers
        (vertex connectivity <= min degree, and connectivity > 2f is the
        classic requirement for agreement with f Byzantine nodes)."""
        return self.min_in_degree > 2 * n_byz


def make_topology(spec, adjacency: np.ndarray) -> Topology:
    """Wrap a raw adjacency mask with its padded gather table and
    diagnostics (all host-side numpy)."""
    adj = np.array(adjacency, dtype=bool)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    np.fill_diagonal(adj, True)
    K = adj.shape[0]
    deg = adj.sum(axis=1).astype(np.int32)               # including self
    deg_max = int(deg.max())
    nbr = np.empty((K, deg_max), dtype=np.int32)
    for r in range(K):
        senders = np.flatnonzero(adj[r])
        nbr[r, :len(senders)] = senders
        nbr[r, len(senders):] = r                        # pad with self
    W = adj / deg[:, None]
    if K > 1:
        mags = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
        gap = float(1.0 - mags[1])
        und = (adj | adj.T).copy()
        np.fill_diagonal(und, False)
        lap = np.diag(und.sum(axis=1)) - und.astype(np.float64)
        fiedler = float(np.sort(np.linalg.eigvalsh(lap))[1])
    else:
        gap, fiedler = 1.0, 0.0
    return Topology(Spec.of(spec), adj, nbr, deg,
                    int((deg - 1).min()), gap, fiedler)


# ---------------------------------------------------------------------------
# Generators (registry namespace "topology") — each returns a (K, K) bool
# adjacency; ``resolve_topology`` wraps it into a Topology. Random graphs
# take an explicit ``seed`` kwarg (numpy, host-side) so a spec string like
# "erdos_renyi(p=0.4, seed=1)" is fully deterministic and cache-stable.
# ---------------------------------------------------------------------------


@register("topology", "complete")
def _complete(K: int) -> np.ndarray:
    """All-to-all broadcast — the paper's Algorithm 3 setting."""
    return np.ones((K, K), dtype=bool)


def _ring_lattice(K: int, k: int) -> np.ndarray:
    adj = np.eye(K, dtype=bool)
    idx = np.arange(K)
    for off in range(1, k // 2 + 1):
        adj[idx, (idx + off) % K] = True
        adj[idx, (idx - off) % K] = True
    return adj


@register("topology", "ring")
def _ring(K: int, k: int = 2) -> np.ndarray:
    """Ring lattice: each agent hears its k nearest ring neighbors
    (k/2 on each side). ``k`` must be even; ``k >= K-1`` is complete."""
    if k < 2 or k % 2:
        raise ValueError(f"ring degree k must be even and >= 2, got {k}")
    if k >= K - 1:
        return _complete(K)
    return _ring_lattice(K, k)


@register("topology", "torus")
def _torus(K: int, rows: Optional[int] = None) -> np.ndarray:
    """2D torus grid with wraparound 4-neighborhoods. ``rows`` defaults to
    the largest divisor of K that is <= sqrt(K) (1 for prime K, which
    degenerates to a ring)."""
    if rows is None:
        rows = max(r for r in range(1, int(np.sqrt(K)) + 1) if K % r == 0)
    if K % rows:
        raise ValueError(f"torus rows={rows} does not divide K={K}")
    cols = K // rows
    adj = np.eye(K, dtype=bool)
    r, c = np.divmod(np.arange(K), cols)
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        adj[np.arange(K), ((r + dr) % rows) * cols + (c + dc) % cols] = True
    return adj


@register("topology", "erdos_renyi")
def _erdos_renyi(K: int, p: float = 0.5, seed: int = 0) -> np.ndarray:
    """Undirected Erdős–Rényi G(K, p): each unordered pair is an edge with
    probability ``p``. May be disconnected — check the diagnostics."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"erdos_renyi edge probability p={p} not in [0,1]")
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((K, K)) < p, k=1)
    return upper | upper.T | np.eye(K, dtype=bool)


@register("topology", "small_world")
def _small_world(K: int, k: int = 4, beta: float = 0.3,
                 seed: int = 0) -> np.ndarray:
    """Watts–Strogatz: ring lattice of degree ``k`` with each rightward
    edge rewired to a uniform random target with probability ``beta``
    (undirected; self-loops and duplicate edges are skipped)."""
    if k < 2 or k % 2:
        raise ValueError(f"small_world degree k must be even >= 2, got {k}")
    if k >= K - 1:
        return _complete(K)
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"small_world beta={beta} not in [0,1]")
    adj = _ring_lattice(K, k)
    np.fill_diagonal(adj, False)
    rng = np.random.default_rng(seed)
    for off in range(1, k // 2 + 1):
        for i in range(K):
            j = (i + off) % K
            if rng.random() < beta:
                target = int(rng.integers(K))
                if target == i or adj[i, target]:
                    continue                  # keep the original edge
                adj[i, j] = adj[j, i] = False
                adj[i, target] = adj[target, i] = True
    return adj | np.eye(K, dtype=bool)


@register("topology", "star")
def _star(K: int, center: int = 0) -> np.ndarray:
    """Hub-and-spoke: the center hears everyone and everyone hears the
    center — the FedPG-BR trusted-server communication pattern, expressed
    as a graph (and exactly as fragile: connectivity 1)."""
    if not 0 <= center < K:
        raise ValueError(f"star center={center} out of range for K={K}")
    adj = np.eye(K, dtype=bool)
    adj[center, :] = True
    adj[:, center] = True
    return adj


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def resolve_topology(topology, K: int) -> Topology:
    """Resolve a topology reference (None | str | Spec | Topology) against
    a federation of size K. ``None`` means the complete broadcast."""
    if isinstance(topology, Topology):
        if topology.K != K:
            raise ValueError(f"topology {topology.name!r} is over "
                             f"{topology.K} agents, config has K={K}")
        return topology
    spec = Spec.of(topology) if topology is not None else Spec("complete")
    return make_topology(spec, resolve("topology", spec, K=K))

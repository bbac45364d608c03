"""Topology resilience on the PyTorch/CUDA port: DecByzPG across gossip
graphs (DESIGN.md §5).

The paper's Algorithm 3 assumes all-to-all broadcast; this sweep asks what
partial connectivity costs. One declarative Experiment sweeps the
``topology`` axis under a per-receiver-equivocating attack and reports,
per graph, the static diagnostics (density, min degree, spectral gap)
next to the learning outcome and the honest parameter diameter Δ₂ — the
agreement-quality number Theorem 2's O(2^-κ) bias term is about. The
star graph is the FedPG-BR trusted-server pattern expressed as a graph:
connectivity 1, no decentralized contraction. Runs on CUDA; ``--device
cpu`` runs the plain PyTorch versions.

  python examples_torch/topology_resilience.py [--iters 40] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import Experiment, obs, resolve_device  # noqa: E402
from repro_torch.topology import resolve_topology  # noqa: E402

TOPOLOGIES = ("complete", "ring(k=4)", "small_world(k=4, beta=0.3)",
              "star")


def main(argv=None):
    """Run the example; returns its ``ExperimentResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--attack", default="avg_zero")
    ap.add_argument("--K", type=int, default=13)
    ap.add_argument("--n-byz", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    exp = Experiment(
        algo="decbyzpg", env="cartpole(horizon=200)", T=args.iters,
        seeds=args.seeds, axes={"topology": TOPOLOGIES},
        K=args.K, n_byz=args.n_byz, attack=args.attack, per_receiver=True,
        aggregator="rfa", agreement="gda", kappa=5, N=20, B=4, eta=2e-2,
        device=dev)
    obs.progress(f"== DecByzPG topology sweep: K={args.K}, {args.n_byz} Byzantine "
                 f"({args.attack}, per-receiver equivocation), {args.seeds} seeds ==")
    res = exp.run()

    obs.progress(f"{'topology':>28s} {'density':>8s} {'min_deg':>8s} {'gap':>6s} "
                 f"{'2f+1?':>6s} {'final_return':>14s} {'Δ₂ (diam)':>10s}")
    for spec in TOPOLOGIES:
        topo = resolve_topology(spec, args.K)
        out = res.sel(topology=spec)
        feasible = "yes" if topo.tolerates(args.n_byz) else "NO"
        obs.progress(f"{topo.name:>28s} {topo.density:8.2f} "
                     f"{topo.min_in_degree:8d} {topo.spectral_gap:6.2f} "
                     f"{feasible:>6s} "
                     f"{out['final_return_mean']:7.1f}±{out['final_return_ci95']:<5.1f} "
                     f"{out['final_diameter_mean']:10.2e}")
    obs.progress("\n(min_deg > 2·n_byz is the necessary BFT connectivity "
                 "condition; graphs failing it cannot bound Byzantine influence "
                 "— watch Δ₂ fail to contract on the star.)")
    return res


if __name__ == "__main__":
    main()

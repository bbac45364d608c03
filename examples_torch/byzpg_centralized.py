"""Centralized ByzPG (paper Algorithm 1 / Figs. 5-6) on the PyTorch/CUDA
port: the warm-up method — trusted server, robust aggregation of worker PG
estimates, PAGE small-batch steps at the server only. Both arms run as one
declarative Experiment with the aggregator axis swept, each scenario's
seeds one lane group's rows, stepped together. Runs on CUDA; ``--device cpu`` runs the plain
PyTorch versions.

  python examples_torch/byzpg_centralized.py [--iters 30] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import Experiment, obs, resolve_device  # noqa: E402


def main(argv=None):
    """Run the example; returns its ``ExperimentResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--attack", default="large_noise")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    exp = Experiment(algo="byzpg", env="cartpole(horizon=200)",
                     T=args.iters, seeds=args.seeds,
                     axes={"aggregator": ("rfa", "mean")},
                     K=13, n_byz=3, attack=args.attack, N=20, B=4, eta=2e-2,
                     device=dev)
    res = exp.run()
    robust = res.sel(aggregator="rfa")
    naive = res.sel(aggregator="mean")
    obs.progress(f"attack={args.attack}, 3/13 Byzantine (centralized, "
                 f"{args.seeds} seeds)")
    obs.progress(f"ByzPG (RFA):        final return "
                 f"{robust['final_return_mean']:.1f}"
                 f"±{robust['final_return_ci95']:.1f}")
    obs.progress(f"Fed-PAGE-PG (mean): final return "
                 f"{naive['final_return_mean']:.1f}±{naive['final_return_ci95']:.1f}")
    return res


if __name__ == "__main__":
    main()

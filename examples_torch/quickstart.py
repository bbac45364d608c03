"""Quickstart: DecByzPG on CartPole with Byzantine agents (paper Fig. 2),
on the PyTorch/CUDA port.

13 agents, 3 Byzantine running the AvgZero attack; DecByzPG (bucketed RFA
aggregation + GDA averaging agreement) vs the naive Dec-PAGE-PG baseline.
One declarative Experiment sweeps the aggregator axis, each scenario's
seeds run together as one lane group's rows, and any ``--attack`` value may be a
parameterized component spec, e.g. ``--attack "large_noise(sigma=10)"``.
Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions.

  python examples_torch/quickstart.py [--iters 40] [--seeds 3] [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import Experiment, obs, resolve_device  # noqa: E402


def main(argv=None):
    """Run the example; returns its ``ExperimentResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--attack", default="avg_zero")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    exp = Experiment(
        algo="decbyzpg", env="cartpole(horizon=200)", T=args.iters,
        seeds=args.seeds, axes={"aggregator": ("rfa", "mean")},
        K=13, n_byz=3, attack=args.attack, N=20, B=4, eta=2e-2,
        override=lambda c: dataclasses.replace(
            c, kappa=0 if c.aggregator.name == "mean" else 5),
        device=dev)
    obs.progress(f"== DecByzPG (robust) vs Dec-PAGE-PG (naive), attack="
                 f"{args.attack}, 3/13 Byzantine, {args.seeds} seeds ==")
    res = exp.run()
    robust = res.sel(aggregator="rfa")
    naive = res.sel(aggregator="mean")

    obs.progress(f"{'samples/agent':>14s} {'DecByzPG':>16s} {'Dec-PAGE-PG':>16s}")
    budget = robust["samples"].mean(axis=0)
    for i in range(0, args.iters, max(args.iters // 10, 1)):
        obs.progress(f"{budget[i]:14.0f} "
                     f"{robust['returns_mean'][i]:8.1f}±{robust['returns_ci95'][i]:<7.1f} "
                     f"{naive['returns_mean'][i]:8.1f}±{naive['returns_ci95'][i]:<7.1f}")
    obs.progress(f"final (mean of last 3, ±95% CI over seeds): "
                 f"DecByzPG={robust['final_return_mean']:.1f}"
                 f"±{robust['final_return_ci95']:.1f}  "
                 f"Dec-PAGE-PG={naive['final_return_mean']:.1f}"
                 f"±{naive['final_return_ci95']:.1f}")
    obs.progress(f"honest parameter diameter under attack: "
                 f"{robust['diameter'][:, -1].mean():.2e} "
                 f"(agreement keeps agents synced)")
    return res


if __name__ == "__main__":
    main()
